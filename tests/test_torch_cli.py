"""The port's CLI against the JAX package's on the CPU: ``main([...,
"--device", "cpu"])`` and JAX's ``cli.main`` on one synthetic multilingual
checkpoint (f32) and the same WAV files.

- transcribe --output-json (sequential and --chunked): the same text,
  language, duration and segments (tokens, seek, t0, t1 identical;
  avg_logprob and no_speech_prob within 1e-4); the txt/srt/vtt/tsv writers
  byte-identical;
- info: the same lines; convert (f16 and f32): a byte-identical file;
- detect-language: the same language; eval: the same WER dict (all but the
  wall-clock rtf); stream: the same printed transcript;
- batch (the SlotEngine) prints the engine's transcripts;
- each subcommand or flag that waits for an unported module exits 2 naming it.

The temperature ladder's sampling rungs cannot match ``jax.random``:
transcribe passes ``--temperature 0``, and eval and stream, which have no
such flag, run with both packages' ladder gate stopped at the first rung.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from whisper_tpu import cli as jax_cli
from whisper_tpu.pipeline import transcribe as jax_transcribe_module
from whisper_tpu_torch import cli
from whisper_tpu_torch.config import SAMPLE_RATE
from whisper_tpu_torch.io.wav import write_wav
from whisper_tpu_torch.pipeline import transcribe as transcribe_module

from fixtures import synthetic_audio, tiny_config, write_synthetic_ggml


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's torch work: the suite runs in
    several worker processes at once, and torch's default of one thread a
    core in each of them oversubscribes the cores (its spinning thread pool
    then slows these decode loops tens of times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    model = str(d / "ggml-tiny-multilingual.bin")
    write_synthetic_ggml(model, tiny_config(n_vocab=51865), seed=9)
    wavs = []
    for i, seconds in enumerate((8, 35)):
        path = str(d / f"clip{i}.wav")
        write_wav(path, synthetic_audio(SAMPLE_RATE * seconds, seed=i + 1))
        wavs.append(path)
    return d, model, wavs


def run(main, argv):
    """(exit code, stdout) of one CLI call in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture
def first_rung_only(monkeypatch):
    for module in (transcribe_module, jax_transcribe_module):
        monkeypatch.setattr(module, "gate_needs_fallback", lambda result, opts: False)


@pytest.mark.parametrize("mode", [[], ["--chunked"]], ids=["sequential", "chunked"])
def test_transcribe_output_json_matches_jax(files, mode):
    d, model, wavs = files
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out_dir = d / f"{name}-{len(mode)}"
        argv = ["transcribe", model, *wavs, "--temperature", "0", *mode,
                "--output-json", str(out_dir / "result.json"), "--output-format", "all",
                "--output-dir", str(out_dir)]
        out_dir.mkdir()
        rc, stdout = run(main, argv + extra)
        assert rc == 0
        with open(out_dir / "result.json") as f:
            outs[name] = json.load(f)
    assert outs["port"].keys() == outs["jax"].keys() == set(wavs)
    for wav in wavs:
        got, want = outs["port"][wav], outs["jax"][wav]
        for key in ("text", "language", "duration"):
            assert got[key] == want[key], key
        assert len(got["segments"]) == len(want["segments"]) > 0
        for g, w in zip(got["segments"], want["segments"]):
            for key in ("id", "seek", "t0", "t1", "text", "tokens", "temperature"):
                assert g[key] == w[key], key
            for key in ("avg_logprob", "no_speech_prob"):
                assert abs(g[key] - w[key]) < 1e-4, key
        stem = os.path.splitext(os.path.basename(wav))[0]
        for ext in ("txt", "srt", "vtt", "tsv"):
            with open(d / f"port-{len(mode)}" / f"{stem}.{ext}", "rb") as f:
                port_bytes = f.read()
            with open(d / f"jax-{len(mode)}" / f"{stem}.{ext}", "rb") as f:
                assert port_bytes == f.read(), ext


def test_info_matches_jax(files):
    _, model, _ = files
    got, want = run(cli.main, ["info", model]), run(jax_cli.main, ["info", model])
    assert got == want and got[1].count("\n") == 6


@pytest.mark.parametrize("f16", [True, False], ids=["f16", "f32"])
def test_convert_is_byte_identical_to_jax(files, f16):
    d, model, _ = files
    flag = ["--f16"] if f16 else []
    port_out, jax_out = str(d / f"port-{f16}.bin"), str(d / f"jax-{f16}.bin")
    assert run(cli.main, ["convert", model, port_out, *flag])[0] == 0
    assert run(jax_cli.main, ["convert", model, jax_out, *flag])[0] == 0
    with open(port_out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()


def test_detect_language_matches_jax(files):
    _, model, wavs = files
    rc, got = run(cli.main, ["detect-language", model, *wavs, "--device", "cpu"])
    assert rc == 0
    want = run(jax_cli.main, ["detect-language", model, *wavs])[1]

    def languages(text):
        return [line.split(": ", 1)[1].split(" ")[0] for line in text.splitlines()]

    assert languages(got) == languages(want) and len(languages(got)) == len(wavs)


def test_eval_matches_jax(files, first_rung_only):
    d, model, _ = files
    data = d / "eval"
    data.mkdir()
    for i, text in enumerate(("alpha bravo", "charlie delta echo")):
        write_wav(str(data / f"utt{i}.wav"),
                  synthetic_audio(SAMPLE_RATE * 6, seed=10 + i))
        (data / f"utt{i}.txt").write_text(text + "\n")
    argv = ["eval", model, str(data), "--dtype", "float32", "--language", "en",
            "--without-timestamps"]
    rc, got = run(cli.main, argv + ["--device", "cpu"])
    assert rc == 0
    got, want = json.loads(got), json.loads(run(jax_cli.main, argv)[1])
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "rtf"} == {
        k: v for k, v in want.items() if k != "rtf"}
    assert got["utterances"] == 2 and got["words"] == 5


def test_stream_matches_jax(files, first_rung_only):
    _, model, wavs = files
    argv = ["stream", model, wavs[1], "--chunk-seconds", "10", "--language", "en"]
    rc, got = run(cli.main, argv + ["--device", "cpu"])
    assert rc == 0
    assert got == run(jax_cli.main, argv)[1]
    assert "== final ==" in got


@pytest.mark.parametrize("argv,module", [
    (["batch", "{model}", "{wav}", "--beam", "2"], "parallel/beam_engine.py (ROADMAP item 13)"),
    (["serve", "{model}"], "parallel/server.py"),
    (["export", "{model}", "{out}"], "utils/aot.py"),
    (["transcribe", "{model}", "{wav}", "--draft", "{model}"], "decoding/speculative.py"),
    (["transcribe", "{model}", "{wav}", "--tp", "2"], "parallel/mesh.py"),
    (["batch", "{model}", "{wav}", "--draft", "{model}"],
     "parallel/spec_engine.py (ROADMAP item 14)"),
    (["batch", "{model}", "{wav}", "--tp", "2"], "ROADMAP item 16"),
], ids=["batch", "serve", "export", "draft", "tp", "batch-draft", "batch-tp"])
def test_unported_subcommands_exit_with_their_module(files, capsys, argv, module):
    d, model, wavs = files
    argv = [a.format(model=model, wav=wavs[0], out=str(d / "x.aot")) for a in argv]
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and module in err


def test_entry_points_default_to_the_card(files, capsys, monkeypatch):
    """Without --device the CLI asks for the card, and without one it exits
    2 with that message instead of running on the CPU."""
    import torch

    _, model, wavs = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["transcribe", model, wavs[0]]) == 2
    assert "no CUDA card" in capsys.readouterr().err
