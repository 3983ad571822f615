"""The port's own copies of the JAX package's host-side modules (config,
errors, io, decoding rules and results, params_from_ggml, logging) against
their originals: equal values, bit-equal arrays, identical filter output."""

import dataclasses

import numpy as np
import pytest

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
