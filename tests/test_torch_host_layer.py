"""The port's own copies of the JAX package's host-side modules (config,
errors, io, decoding rules and results, params_from_ggml, logging) against
their originals: equal values, bit-equal arrays, identical filter output."""

import dataclasses

import numpy as np
import pytest
import torch

from whisper_tpu import config as jax_config
from whisper_tpu.decoding import result as jax_result
from whisper_tpu.decoding import rules as jax_rules
from whisper_tpu.io import ggml as jax_ggml
from whisper_tpu.io import vocab as jax_vocab
from whisper_tpu.model.params import params_from_ggml as jax_params_from_ggml
from whisper_tpu_torch import config, errors
from whisper_tpu_torch.decoding import result, rules
from whisper_tpu_torch.io import ggml, vocab
from whisper_tpu_torch.model.params import params_from_ggml
from whisper_tpu_torch.utils.logging import StageTimers, get_logger

from fixtures import micro_config, random_tensors, synthetic_tokens, write_synthetic_ggml


def test_presets_and_constants_equal():
    assert config.PRESETS.keys() == jax_config.PRESETS.keys()
    for name, cfg in config.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config.PRESETS[name]), name
        ref = jax_config.PRESETS[name]
        assert (cfg.model_type, cfg.is_multilingual, cfg.d_head_text, cfg.d_head_audio) == (
            ref.model_type, ref.is_multilingual, ref.d_head_text, ref.d_head_audio)
        assert cfg.hbm_bytes_estimate() == ref.hbm_bytes_estimate()
    assert dataclasses.asdict(config.WhisperConfig()) == dataclasses.asdict(
        jax_config.WhisperConfig())
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_SIZE", "N_SAMPLES_PER_CHUNK"):
        assert getattr(config, name) == getattr(jax_config, name), name
    with pytest.raises(ValueError):
        config.WhisperConfig(n_mels=64).validate()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "micro.bin"
    write_synthetic_ggml(path, micro_config(), seed=4)
    return str(path), ggml.load_ggml(str(path), verbose=False), jax_ggml.load_ggml(
        str(path), verbose=False)


def test_ggml_reader_and_vocab_equal(checkpoint):
    _, ours, ref = checkpoint
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(ref.config)
    np.testing.assert_array_equal(ours.filters, ref.filters)
    assert ours.tensors.keys() == ref.tensors.keys()
    for name in ref.tensors:
        np.testing.assert_array_equal(ours.tensors[name], ref.tensors[name])
    v, rv = ours.vocab, ref.vocab
    assert v.id_to_token == rv.id_to_token and v.token_to_id == rv.token_to_id
    for field in ("n_vocab", "token_eot", "token_sot", "token_translate", "token_transcribe",
                  "token_solm", "token_prev", "token_nosp", "token_not", "token_beg",
                  "languages", "is_multilingual"):
        assert getattr(v, field) == getattr(rv, field), field
    assert v.non_speech_tokens() == rv.non_speech_tokens()
    assert v.decode([5, 220, 7, v.token_eot]) == rv.decode([5, 220, 7, rv.token_eot])
    for text in (" hello <t5> world<t17>", "<t220><t5>é"):
        assert v.encode(text) == rv.encode(text)
    for n in (51864, 51865, 51866):
        assert vocab.device_special_ids(n) == jax_vocab.device_special_ids(n)
        assert vocab.build_special_ids(n) == jax_vocab.build_special_ids(n)
        mv = vocab.make_vocab(n, synthetic_tokens(51864), 51864)
        rmv = jax_vocab.make_vocab(n, synthetic_tokens(51864), 51864)
        assert mv.id_to_token == rmv.id_to_token
        assert mv.language_token("de") == rmv.language_token("de")


def test_ggml_writer_round_trips_through_the_jax_reader(checkpoint, tmp_path):
    _, ours, ref = checkpoint
    path = tmp_path / "rewritten.bin"
    ggml.write_ggml(str(path), ours.config, ours.filters, synthetic_tokens(51864),
                    ours.tensors)
    back = jax_ggml.load_ggml(str(path), verbose=False)
    assert ggml.tensor_schema(ours.config) == jax_ggml.tensor_schema(ref.config)
    for name in ref.tensors:
        np.testing.assert_array_equal(back.tensors[name], ref.tensors[name])


def test_ggml_errors_are_the_ports_own(checkpoint, tmp_path):
    path, _, _ = checkpoint
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0\0\0\0" + open(path, "rb").read()[4:64])
    with pytest.raises(errors.BadMagicError):
        ggml.load_ggml(str(bad), verbose=False)
    short = tmp_path / "short.bin"
    short.write_bytes(open(path, "rb").read()[:30])
    with pytest.raises(errors.TruncatedFileError):
        ggml.load_ggml(str(short), verbose=False)
    assert issubclass(errors.UnsupportedFtypeError, errors.WhisperError)


def test_params_from_ggml_bit_equal():
    cfg = micro_config()
    tensors = random_tensors(cfg, seed=8)
    ours, ref = params_from_ggml(tensors, cfg), jax_params_from_ggml(tensors, cfg)

    def leaves(tree, prefix=""):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from leaves(tree[key], f"{prefix}{key}.")
            else:
                yield prefix + key, tree[key]

    got, want = dict(leaves(ours)), dict(leaves(ref))
    assert got.keys() == want.keys()
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], arr)


@pytest.mark.parametrize("without_timestamps", [True, False])
def test_logit_filters_equal(checkpoint, without_timestamps):
    """The host filter chain on random logits after random histories,
    including the first sampled position."""
    _, ours, ref = checkpoint
    rng = np.random.default_rng(int(without_timestamps))
    sample_begin = 3
    chains = []
    for mod, v in ((rules, ours.vocab), (jax_rules, ref.vocab)):
        chain = [mod.SuppressBlank(v, sample_begin),
                 mod.SuppressTokens(mod.build_suppress_list(v, (-1, 11, 12)))]
        if not without_timestamps:
            chain.append(mod.ApplyTimestampRules(v, sample_begin, 50))
        chains.append(chain)
    assert rules.build_suppress_list(ours.vocab) == jax_rules.build_suppress_list(ref.vocab)
    beg = ours.vocab.token_beg
    for n_sampled in (0, 1, 2, 5):
        tokens = np.concatenate(
            [np.tile([ours.vocab.token_sot, 7, 8], (4, 1)),
             np.where(rng.random((4, n_sampled)) < 0.5, rng.integers(beg, beg + 30, (4, n_sampled)),
                      rng.integers(0, 50000, (4, n_sampled)))], axis=1)
        logits = rng.standard_normal((4, ours.config.n_vocab)).astype(np.float32) * 3
        got, want = logits.copy(), logits.copy()
        for f in chains[0]:
            f(got, tokens)
        for f in chains[1]:
            f(want, tokens)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rules.log_softmax(logits), jax_rules.log_softmax(logits))


def test_result_and_logging():
    for text in ("", "hello hello hello hello", "a b c d e f g"):
        assert result.compression_ratio(text) == jax_result.compression_ratio(text)
    assert [f.name for f in dataclasses.fields(result.DecodingResult)] == [
        f.name for f in dataclasses.fields(jax_result.DecodingResult)]
    timers = StageTimers()
    with timers.stage("mel"):
        pass
    with timers.stage("mel"):
        pass
    assert timers.counts == {"mel": 2} and timers.totals["mel"] >= 0
    assert get_logger("x").name == "whisper_tpu_torch.x"


# The whisper_full slice's copies: wav, token timestamps, normalizers, WER,
# writers, the word-timing helpers, and the additions to result, vocab and
# config.

from whisper_tpu.io import wav as jax_wav  # noqa: E402
from whisper_tpu.pipeline import timestamps as jax_timestamps  # noqa: E402
from whisper_tpu.pipeline import word_timing as jax_word_timing  # noqa: E402
from whisper_tpu.utils import normalizers as jax_normalizers  # noqa: E402
from whisper_tpu.utils import wer as jax_wer  # noqa: E402
from whisper_tpu.utils import writers as jax_writers  # noqa: E402
from whisper_tpu_torch.io import wav  # noqa: E402
from whisper_tpu_torch.pipeline import timestamps, word_timing  # noqa: E402
from whisper_tpu_torch.utils import normalizers, wer, writers  # noqa: E402


def _wav_files(tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal(16000) * 0.2).astype(np.float32)
    files = {}
    for name, rate, data in (
            ("mono16k", 16000, (pcm * 32767).astype(np.int16)),
            ("stereo8k", 8000, (np.stack([pcm, -pcm], axis=1)[:8000] * 32767).astype(np.int16)),
            ("f32-22k", 22050, pcm[:11025]),
            ("i32", 16000, (pcm * 2 ** 30).astype(np.int32)),
            ("u8", 16000, (pcm * 100 + 128).astype(np.uint8))):
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, rate, data)
        files[name] = path
    return files, pcm


def test_wav_copy_equal(tmp_path):
    files, pcm = _wav_files(tmp_path)
    for name, path in files.items():
        np.testing.assert_array_equal(wav.load_wav(path), jax_wav.load_wav(path), err_msg=name)
    with pytest.raises(errors.AudioError):
        wav.load_wav(files["stereo8k"], resample=False)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF0000")
    with pytest.raises(errors.AudioError):
        wav.load_wav(str(bad))
    ours, ref = str(tmp_path / "ours.wav"), str(tmp_path / "ref.wav")
    wav.write_wav(ours, pcm * 3)
    jax_wav.write_wav(ref, pcm * 3)
    assert open(ours, "rb").read() == open(ref, "rb").read()


def test_token_timestamps_copy_equal(checkpoint):
    _, ours, ref = checkpoint
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal(16000 * 12) * np.repeat(rng.random(120), 1600)).astype(
        np.float32)
    beg = ours.vocab.token_beg
    fields = dict(id=0, seek=300, t0=3.0, t1=9.5, text="", avg_logprob=-0.5,
                  no_speech_prob=0.1, temperature=0.0, compression_ratio=1.0)
    token_lists = ([beg + 5, 220, 7, 8, 9, beg + 100, 11, 12, beg + 300],
                   [5, 6, 220, 7], [], [beg, beg + 1])
    for toks in token_lists:
        segs = [result.Segment(tokens=list(toks), **fields)]
        jsegs = [jax_result.Segment(tokens=list(toks), **fields)]
        for energy_audio in (audio, None):
            timestamps.add_token_timestamps(segs, ours.vocab, energy_audio)
            jax_timestamps.add_token_timestamps(jsegs, ref.vocab, energy_audio)
            assert [dataclasses.asdict(t) for t in segs[0].token_data] == [
                dataclasses.asdict(t) for t in jsegs[0].token_data]
    for text in (b" hello", b"a.b", b"\xff\xfe", b" "):
        assert timestamps.token_voice_length(text) == jax_timestamps.token_voice_length(text)
    assert [f.name for f in dataclasses.fields(result.Segment)] == [
        f.name for f in dataclasses.fields(jax_result.Segment)]
    assert [f.name for f in dataclasses.fields(result.TokenData)] == [
        f.name for f in dataclasses.fields(jax_result.TokenData)]


_TEXTS = ["Mr. Smith's colour TV costs twenty-five dollars and fifty cents!",
          "I'm gonna travel 3rd class on the 21st of March, 1999 [music]",
          "The organisation's theatre programme was cancelled (again) — ok?",
          "It's one point five percent, i.e. about a half… hmm",
          "Ça coûte cinquante euros; naïve café, ½ price"]


def test_normalizers_and_wer_copy_equal():
    pairs = [(normalizers.EnglishTextNormalizer(), jax_normalizers.EnglishTextNormalizer()),
             (normalizers.BasicTextNormalizer(), jax_normalizers.BasicTextNormalizer()),
             (normalizers.BasicTextNormalizer(remove_diacritics=True),
              jax_normalizers.BasicTextNormalizer(remove_diacritics=True))]
    for text in _TEXTS:
        for ours, ref in pairs:
            assert ours(text) == ref(text), text
    refs, hyps = _TEXTS[:4], [t.upper().replace("a", "e") for t in _TEXTS[1:]]
    for normalize in (True, False):
        assert wer.wer(refs, hyps, normalize) == jax_wer.wer(refs, hyps, normalize)
    assert wer.edit_distance(list("kitten"), list("sitting")) == jax_wer.edit_distance(
        list("kitten"), list("sitting"))


def test_writers_copy_equal():
    import io

    res = {"text": "a b", "segments": [
        {"t0": 0.0, "t1": 1.234, "text": " first\tcue", "words": [
            {"word": " first", "start": 0.0, "end": 0.5}, {"word": " cue", "start": 0.6,
                                                            "end": 1.2}]},
        {"t0": 3661.5, "t1": 3700.0, "text": " second", "words": None}]}
    calls = [("write_txt", {}), ("write_tsv", {}), ("write_srt", {}), ("write_vtt", {}),
             ("write_srt", {"highlight_words": True}), ("write_vtt", {"highlight_words": True})]
    for name, kw in calls:
        ours, ref = io.StringIO(), io.StringIO()
        getattr(writers, name)(res, ours, **kw)
        getattr(jax_writers, name)(res, ref, **kw)
        assert ours.getvalue() == ref.getvalue(), name


def test_word_timing_helpers_copy_equal(checkpoint):
    _, ours, ref = checkpoint
    rng = np.random.default_rng(4)
    for shape, width in (((3, 9, 40), 7), ((2, 5), 3), ((4, 3), 7), ((6,), 1)):
        x = rng.standard_normal(shape)
        np.testing.assert_array_equal(word_timing.median_filter(x, width),
                                      jax_word_timing.median_filter(x, width))
    for n, m in ((1, 1), (5, 30), (30, 7), (12, 12)):
        cost = rng.standard_normal((n, m))
        cost[:, ::3] = 0.0  # ties
        for a, b in zip(word_timing.dtw(cost), jax_word_timing.dtw(cost)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(word_timing.default_alignment_heads(6, 4),
                                  jax_word_timing.default_alignment_heads(6, 4))
    assert config.ALIGNMENT_HEADS == jax_config.ALIGNMENT_HEADS
    for name, cfg in config.PRESETS.items():
        assert config.lookup_alignment_heads(cfg) == jax_config.lookup_alignment_heads(
            jax_config.PRESETS[name]), name
        np.testing.assert_array_equal(
            word_timing.model_alignment_heads(cfg, cfg.n_text_layer, cfg.n_text_head),
            jax_word_timing.model_alignment_heads(jax_config.PRESETS[name], cfg.n_text_layer,
                                                  cfg.n_text_head))
    tokens = [5, 220, 6, 7, ours.vocab.token_eot, 8, ours.vocab.token_beg + 3, 9]
    assert word_timing.split_tokens_on_spaces(ours.vocab, tokens) == \
        jax_word_timing.split_tokens_on_spaces(ref.vocab, tokens)
    v, rv = ours.vocab, ref.vocab
    for t in (0, 220, v.token_eot, v.token_beg, v.token_beg + 17, 10 ** 6):
        assert v.is_timestamp(t) == rv.is_timestamp(t)
        assert v.timestamp_to_seconds(t) == rv.timestamp_to_seconds(t)
        assert v.token_bytes(t) == rv.token_bytes(t)


# The entry points' slice: the tone-word corpus, params_to_ggml, the
# in-memory WAV reader and the timers' report.

from whisper_tpu.model.params import params_to_ggml as jax_params_to_ggml  # noqa: E402
from whisper_tpu.utils import logging as jax_logging  # noqa: E402
from whisper_tpu.utils import synth as jax_synth  # noqa: E402
from whisper_tpu_torch.model.params import params_to_ggml, params_to_torch  # noqa: E402
from whisper_tpu_torch.utils import synth  # noqa: E402


@pytest.mark.parametrize("n_words,repeat", [((1, 3), 1), ((3, 3), 2), ((2, 5), 3)])
def test_synth_copy_equal(n_words, repeat):
    """The same audio (bit-equal) and transcript for the same default_rng
    seed, with and without repeat; the same word token table."""
    ours, ref = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(4):
        audio, text = synth.make_pair(ours, n_words=n_words, repeat=repeat)
        want_audio, want_text = jax_synth.make_pair(ref, n_words=n_words, repeat=repeat)
        assert text == want_text and audio.dtype == want_audio.dtype == np.float32
        np.testing.assert_array_equal(audio, want_audio)
    np.testing.assert_array_equal(synth.word_audio(3, np.random.default_rng(1)),
                                  jax_synth.word_audio(3, np.random.default_rng(1)))
    assert synth.word_tokens(51864) == jax_synth.word_tokens(51864)
    assert (synth.SR, synth.WORD_SEC, synth.WORDS) == (jax_synth.SR, jax_synth.WORD_SEC,
                                                      jax_synth.WORDS)


def test_params_to_ggml_equal():
    """The inverse of params_from_ggml, from numpy arrays and from tensors,
    equals JAX's on the same tree."""
    cfg = micro_config()
    tensors = random_tensors(cfg, seed=8)
    tree = params_from_ggml(tensors, cfg)
    want = jax_params_to_ggml(jax_params_from_ggml(tensors, cfg), cfg)
    for got in (params_to_ggml(tree, cfg), params_to_ggml(params_to_torch(tree, "cpu",
                                                                          torch.float32), cfg)):
        assert got.keys() == want.keys() == tensors.keys()
        for name, arr in want.items():
            assert got[name].shape == arr.shape, name
            np.testing.assert_array_equal(got[name], arr)
            np.testing.assert_array_equal(got[name], tensors[name].astype(np.float32))


def test_load_wav_bytes_and_timer_report_equal(tmp_path):
    files, _ = _wav_files(tmp_path)
    for name, path in files.items():
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(wav.load_wav_bytes(data), jax_wav.load_wav_bytes(data),
                                      err_msg=name)
    with pytest.raises(errors.AudioError):
        wav.load_wav_bytes(b"RIFF0000")
    ours, ref = StageTimers(), jax_logging.StageTimers()
    for t in (ours, ref):
        t.totals.update({"mel": 0.012345, "decode": 1.5})
        t.counts.update({"mel": 2, "decode": 1})
    assert ours.report() == ref.report()
