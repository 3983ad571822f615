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
- batch (the SlotEngine) prints the engine's transcripts; batch --beam
  (the BeamSlotEngine, with and without --long-form) prints JAX's
  BeamSlotEngine's on the same bf16 model;
- serve on a loopback port answers /transcribe with the engine's own
  result and exits 0 on SIGTERM;
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
    (["serve", "{model}", "--draft", "{model}"], "parallel/spec_engine.py (ROADMAP item 14)"),
    (["serve", "{model}", "--tp", "2"], "ROADMAP item 16"),
    (["serve", "{model}", "--profiler-port", "9999"], "ROADMAP item 18"),
    (["export", "{model}", "{out}"], "utils/aot.py"),
    (["transcribe", "{model}", "{wav}", "--draft", "{model}"], "decoding/speculative.py"),
    (["transcribe", "{model}", "{wav}", "--tp", "2"], "parallel/mesh.py"),
    (["batch", "{model}", "{wav}", "--draft", "{model}"],
     "parallel/spec_engine.py (ROADMAP item 14)"),
    (["batch", "{model}", "{wav}", "--tp", "2"], "ROADMAP item 16"),
], ids=["serve-draft", "serve-tp", "serve-profiler", "export", "draft", "tp", "batch-draft",
        "batch-tp"])
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


def test_batch_beam_matches_jax_beam_engine(files, monkeypatch, first_rung_only):
    """batch --beam 2 (transcribe_many over beam groups) and with
    --long-form (beam windows through transcribe_streams) print what JAX's
    BeamSlotEngine gives on the same model and WAVs. Both run in f32 (the
    CLI loads bf16, whose last bits differ between the packages and can part
    the beams): the port's load_model is made to load f32 here, and both
    ladders stop at the first rung (sampling cannot match jax.random). JAX's own
    cli batch --beam cannot be the reference: it passes audio_ctx, which
    JAX's BeamSlotEngine does not take."""
    import jax.numpy as jnp

    from whisper_tpu.decoding.task import DecodingOptions as JaxOptions
    from whisper_tpu.io.wav import load_wav
    from whisper_tpu.model.load import load_model as jax_load_model
    from whisper_tpu.parallel.beam_engine import BeamSlotEngine as JaxBeamEngine
    from whisper_tpu.pipeline.transcribe import TranscribeOptions as JaxTranscribeOptions
    from whisper_tpu_torch.model import load as load_module

    _, model, wavs = files
    jm = jax_load_model(model, dtype=jnp.float32, use_native=False)
    audios = [load_wav(p) for p in wavs]
    many = JaxBeamEngine(jm, n_slots=2, options=JaxOptions(beam_size=2, without_timestamps=True)
                         ).transcribe_many(audios)
    streams = JaxBeamEngine(jm, n_slots=2, options=JaxOptions(beam_size=2)).transcribe_streams(
        audios, JaxTranscribeOptions(beam_size=2))
    real_load = load_module.load_model
    monkeypatch.setattr(load_module, "load_model", lambda path, device, dtype: real_load(
        path, device=device, dtype=torch.float32))
    for flags, files_, expect in (
            ([], wavs, [f"== {p}: {r.text}" for p, r in zip(wavs, many)]),
            (["--long-form"], wavs, [f"== {p}: {r['text']}" for p, r in zip(wavs, streams)])):
        rc, out = run(cli.main, ["batch", model, *files_, "--beam", "2", "--slots", "2",
                                 "--device", "cpu", *flags])
        assert rc == 0
        lines = out.strip().splitlines()
        assert lines[:-1] == expect and "realtime, 2 slots" in lines[-1]


@pytest.mark.parametrize("beam", [[], ["--beam", "2"]], ids=["greedy", "beam"])
def test_serve_on_a_loopback_port(files, beam, first_rung_only):
    """cli serve on 127.0.0.1 (port 0), on this process's main thread as a
    daemon runs it: a client thread reads the announced port, checks
    /healthz, POSTs a WAV to /transcribe (the engine's own
    transcribe_streams result, ladder stopped at the first rung), then
    sends SIGTERM as a Python-level signal; serve drains and returns 0.
    Every wait is bounded."""
    import _thread
    import re
    import signal
    import threading
    import time

    import http.client

    from whisper_tpu_torch.decoding.task import DecodingOptions
    from whisper_tpu_torch.io.wav import load_wav
    from whisper_tpu_torch.model.load import load_model
    from whisper_tpu_torch.parallel.beam_engine import BeamSlotEngine
    from whisper_tpu_torch.parallel.engine import SlotEngine
    from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions

    _, model, wavs = files
    k = int(beam[1]) if beam else None
    m = load_model(model, device="cpu", dtype=torch.bfloat16, use_native=False)
    eng = (BeamSlotEngine(m, n_slots=2, options=DecodingOptions(beam_size=k)) if k
           else SlotEngine(m, n_slots=2))
    want = eng.transcribe_streams([load_wav(wavs[0])], TranscribeOptions(beam_size=k))[0]

    out, seen = io.StringIO(), {}

    def client():
        end = time.monotonic() + 600
        while not (found := re.search(r"serving on http://127\.0\.0\.1:(\d+)", out.getvalue())):
            if time.monotonic() > end:
                seen["error"] = "the server never announced itself"
                return
            time.sleep(0.05)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", int(found.group(1)), timeout=600)
            conn.request("GET", "/healthz")
            seen["health"] = json.loads(conn.getresponse().read())
            with open(wavs[0], "rb") as f:
                conn.request("POST", "/transcribe", body=f.read())
            resp = conn.getresponse()
            seen["status"], seen["result"] = resp.status, json.loads(resp.read())
            conn.close()
        finally:
            # the Python-level SIGTERM handler serve installed before the
            # announcement; a no-op where none is installed
            _thread.interrupt_main(signal.SIGTERM)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["serve", model, "--port", "0", "--slots", "2", "--device", "cpu", *beam])
    t.join(timeout=600)
    assert not t.is_alive() and "error" not in seen
    assert rc == 0 and "draining" in out.getvalue()
    assert seen["health"]["ok"] is True and seen["status"] == 200
    got = seen["result"]
    assert (got["text"], got["duration"]) == (want["text"], want["duration"])
    assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in want["segments"]]
