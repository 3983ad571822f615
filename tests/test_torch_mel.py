"""Port mel frontend vs whisper_tpu.frontend.mel (f32, within 2e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.frontend import mel as jax_mel
from whisper_tpu_torch.frontend import mel as torch_mel

from fixtures import synthetic_audio


@pytest.mark.parametrize("n_mels,n_fft", [(80, 400), (128, 400), (80, 200)])
def test_filter_bank_equals_jax_package(n_mels, n_fft):
    np.testing.assert_array_equal(torch_mel.mel_filter_bank(n_mels, n_fft),
                                  jax_mel.mel_filter_bank(n_mels, n_fft))


@pytest.mark.parametrize("center,fold,speed_up,n_samples", [
    (True, False, False, 16000 * 5),   # openai mode
    (False, True, False, 16000 * 5),   # whisper.cpp-1.0.3 mode
    (True, False, True, 16000 * 3),    # speed_up, filters over 101 bins
    (True, False, False, 180),         # shorter than the reflect pad
])
def test_log_mel_matches_jax(center, fold, speed_up, n_samples):
    audio = synthetic_audio(n_samples, seed=4)
    filters = jax_mel.mel_filter_bank(80, 200 if speed_up else 400)
    n = jax_mel.frame_count(len(audio), center)
    ref = np.asarray(jax_mel.log_mel_spectrogram(
        jnp.asarray(audio), jnp.asarray(filters), n, center=center, fold=fold,
        speed_up=speed_up))
    ours = torch_mel.log_mel_spectrogram(
        torch.from_numpy(audio), torch.from_numpy(filters), n, center=center,
        fold=fold, speed_up=speed_up).numpy()
    assert ours.shape == ref.shape == (80, n)
    # 2e-4: the JAX package's own bound against its float64 golden model;
    # the two f32 DFT products sum in another order.
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_mel_window_and_helpers_match_jax():
    mel = np.random.default_rng(0).standard_normal((80, 250)).astype(np.float32)
    for offset, n in ((0, 300), (100, 100), (240, 50), (400, 20)):
        np.testing.assert_array_equal(
            torch_mel.mel_window(torch.from_numpy(mel), offset, n).numpy(),
            np.asarray(jax_mel.mel_window(jnp.asarray(mel), offset, n)))
    np.testing.assert_array_equal(torch_mel.hann_window_np(), jax_mel.hann_window_np())
    for n in (0, 159, 160, 480_000):
        assert torch_mel.frame_count(n) == jax_mel.frame_count(n)


@pytest.mark.parametrize("center,fold", [(True, False), (False, True)])
def test_batched_rows_are_each_their_own_clip(center, fold):
    """(G, n) audio in one pass: each row gets its own reflect padding and
    max normalisation (rows at different gains), as JAX's log_mel of that
    row alone, within the same 2e-4, and the port's 1-D call on the row."""
    rows = np.stack([synthetic_audio(16000 * 2, seed=s) * g
                     for s, g in ((1, 1.0), (2, 0.01), (3, 0.3))])
    filters = jax_mel.mel_filter_bank(80, 400)
    n = jax_mel.frame_count(rows.shape[1], center)
    ours = torch_mel.log_mel_spectrogram(torch.from_numpy(rows), torch.from_numpy(filters), n,
                                         center=center, fold=fold).numpy()
    assert ours.shape == (3, 80, n)
    for row, got in zip(rows, ours):
        ref = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(row), jnp.asarray(filters), n,
                                                     center=center, fold=fold))
        np.testing.assert_allclose(got, ref, atol=2e-4)
        one = torch_mel.log_mel_spectrogram(torch.from_numpy(row), torch.from_numpy(filters), n,
                                            center=center, fold=fold).numpy()
        # the same f32 products over more rows: equal up to the sum order
        np.testing.assert_allclose(got, one, atol=1e-5)
