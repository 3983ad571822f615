"""The port's native C++ runtime (its own copy of whisper_rt.cc, built with
g++ into build/native/) against the pure-Python readers, as
tests/test_native.py holds the JAX package's, and its WAV and GGML reads
equal to the JAX package's runtime on the same files."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from whisper_tpu.runtime import native as jax_native
from whisper_tpu_torch.io.ggml import load_ggml
from whisper_tpu_torch.io.wav import load_wav
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.runtime import native
from whisper_tpu_torch.runtime.native import NativeAudioLoader, native_load_wav

from fixtures import synthetic_audio, tiny_config, write_synthetic_ggml


@pytest.fixture(scope="module")
def ggml_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "m.bin")
    write_synthetic_ggml(path, tiny_config(), seed=3)
    return path


def test_runtime_builds_from_the_ports_source_into_build():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert native.SOURCE.parent.parent.name == "runtime"  # never built beside the source
    assert not list(native.SOURCE.parent.glob("*.so"))


def test_native_wav_matches_python(tmp_path):
    audio = synthetic_audio(16000 * 3)
    p = str(tmp_path / "a.wav")
    wavfile.write(p, 16000, (audio * 32767).astype(np.int16))
    out = native_load_wav(p)
    assert out is not None
    rate, data = out
    assert rate == 16000
    np.testing.assert_allclose(data, (audio * 32767).astype(np.int16) / 32768.0, atol=1e-6)
    before = native.reads.get("wav-native", 0)
    np.testing.assert_allclose(load_wav(p), data, atol=1e-7)  # load_wav reads natively
    assert native.reads["wav-native"] == before + 1


def test_native_wav_stereo_downmix(tmp_path):
    audio = synthetic_audio(16000)
    stereo = np.stack([audio, -audio], axis=1)  # downmix to ~0
    p = str(tmp_path / "s.wav")
    wavfile.write(p, 16000, (stereo * 32767).astype(np.int16))
    _, data = native_load_wav(p)
    assert np.abs(data).max() < 1e-3


def test_native_ggml_matches_python(ggml_path):
    cfg = tiny_config()
    header, filters, tokens, tensors = native.native_open_ggml(ggml_path)
    ckpt = load_ggml(ggml_path, verbose=False)
    assert header == [
        cfg.n_vocab, cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_audio_head,
        cfg.n_audio_layer, cfg.n_text_ctx, cfg.n_text_state, cfg.n_text_head,
        cfg.n_text_layer, cfg.n_mels, cfg.f16,
    ]
    np.testing.assert_array_equal(filters, ckpt.filters)
    assert tokens == [ckpt.vocab.id_to_token[i] for i in range(len(tokens))]
    assert set(tensors) == set(ckpt.tensors)
    for name in tensors:
        np.testing.assert_array_equal(tensors[name], ckpt.tensors[name])


def test_native_ggml_bad_magic(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"\x01" * 128)
    with pytest.raises(RuntimeError, match="bad magic"):
        native.native_open_ggml(str(p))


def test_load_model_via_native(ggml_path):
    before = dict(native.reads)
    m_native = load_model(ggml_path, device="cpu", use_native=True)
    m_python = load_model(ggml_path, device="cpu", use_native=False)
    assert native.reads["ggml-native"] == before.get("ggml-native", 0) + 1
    assert native.reads["ggml-python"] == before.get("ggml-python", 0) + 1
    for a, b in zip(*(torch.utils._pytree.tree_leaves(m.params) for m in (m_native, m_python))):
        assert torch.equal(a, b)
    assert m_native.vocab.id_to_token == m_python.vocab.id_to_token
    assert torch.equal(m_native.filters, m_python.filters)


def test_native_audio_loader_threads(tmp_path):
    """Threaded prefetch: every file decoded, in submission order, equal to
    the synchronous native read."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        audio = (rng.standard_normal(16000 + 1000 * i) * 8000).astype(np.int16)
        p = str(tmp_path / f"a{i}.wav")
        wavfile.write(p, 16000, audio)
        paths.append(p)
    loader = NativeAudioLoader(paths, n_threads=3)
    got = list(loader)
    loader.close()
    assert [g[0] for g in got] == list(range(6))
    for i, rate, audio in got:
        ref = native_load_wav(paths[i])
        assert rate == ref[0] == 16000
        np.testing.assert_array_equal(audio, ref[1])


def test_native_audio_loader_missing_file(tmp_path):
    loader = NativeAudioLoader([str(tmp_path / "nope.wav")], n_threads=2)
    assert loader.get(0) is None
    loader.close()


@pytest.fixture
def jax_runtime(tmp_path, monkeypatch):
    """The JAX package's runtime built from its own source with g++ into
    ``tmp_path`` and loaded for this test alone. Its lazy in-tree ``make``
    writes one shared library in place: several test workers importing
    tests/test_native.py at once can each find it missing or half written,
    and such a worker keeps None for its lifetime."""
    src = Path(jax_native.__file__).parent / "native" / "whisper_rt.cc"
    lib_path = tmp_path / "libwhisper_rt.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", "-pthread", "-shared", "-o",
                    str(lib_path), str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    jax_native._configure(lib)
    monkeypatch.setattr(jax_native, "_LIB", lib)
    monkeypatch.setattr(jax_native, "_LIB_TRIED", True)
    return jax_native


def test_reads_equal_the_jax_runtime(tmp_path, ggml_path, jax_runtime):
    """The same WAV (16-bit stereo at 8 kHz, resampled by load_wav) and the
    same GGML file through both packages' runtimes: bit-equal."""
    assert jax_native.available()
    rng = np.random.default_rng(5)
    p = str(tmp_path / "stereo8k.wav")
    wavfile.write(p, 8000, (rng.standard_normal((8000, 2)) * 6000).astype(np.int16))
    rate, data = native_load_wav(p)
    jrate, jdata = jax_native.native_load_wav(p)
    assert rate == jrate == 8000
    np.testing.assert_array_equal(data, jdata)
    from whisper_tpu.io.wav import load_wav as jax_load_wav
    np.testing.assert_array_equal(load_wav(p), jax_load_wav(p))

    ours, theirs = native.native_open_ggml(ggml_path), jax_native.native_open_ggml(ggml_path)
    assert ours[0] == theirs[0] and ours[2] == theirs[2]
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[3].keys() == theirs[3].keys()
    for name in ours[3]:
        assert ours[3][name].dtype == theirs[3][name].dtype
        np.testing.assert_array_equal(ours[3][name], theirs[3][name])
