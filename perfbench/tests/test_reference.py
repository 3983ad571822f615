"""The plain reference against the port at a tiny size on seeded weights
(CPU, float32): the log-mel, the encoder's cross keys and values, and the
decoder's logits over a prompt and tokens, float and in int8."""

import numpy as np
import pytest
import torch

from perfbench import families
from perfbench.reference.mel import log_mel, mel_filters, padded_length, window
from perfbench.reference.model import Reference
from perfbench.reference.special import Special
from perfbench.tests.rehearsal import TINY
from perfbench.traffic import make_bank

SEED = 977


@pytest.fixture(scope="module")
def both():
    from whisper_tpu_torch.config import WhisperConfig
    from whisper_tpu_torch.model.decoder import TextDecoder
    from whisper_tpu_torch.model.encoder import AudioEncoder

    torch.manual_seed(0)
    d = TINY
    cfg = WhisperConfig(d["n_vocab"], d["n_audio_ctx"], d["n_state"], d["n_head"],
                        d["n_audio_layer"], d["n_text_ctx"], d["n_state"], d["n_head"],
                        d["n_text_layer"], d["n_mels"], 1)
    tree = families.load("whisper").draw(d, SEED, torch.float32, "cpu")
    return cfg, tree


def port_mel(pcm, n_mels):
    from whisper_tpu_torch.frontend.mel import frame_count, log_mel_spectrogram

    from whisper_tpu_torch.frontend.mel import mel_filter_bank
    n = padded_length(len(pcm))
    audio = np.zeros(n, np.float32)
    audio[: len(pcm)] = pcm / 32768.0
    filt = torch.from_numpy(mel_filter_bank(n_mels))
    return log_mel_spectrogram(torch.from_numpy(audio), filt, frame_count(n))


def test_mel_filters_and_log_mel_match_the_port():
    from whisper_tpu_torch.frontend.mel import mel_filter_bank

    for n_mels in (80, 128):
        assert np.allclose(mel_filters(n_mels), mel_filter_bank(n_mels), atol=1e-7)
    pcm = make_bank(5, 23.0)
    ref, port = log_mel(pcm, 128, "cpu"), port_mel(pcm, 128)
    assert ref.shape == port.shape
    assert torch.allclose(ref, port, atol=2e-4)


def _port_parts(cfg, tree, quantized):
    from whisper_tpu_torch.model.decoder import TextDecoder
    from whisper_tpu_torch.model.encoder import AudioEncoder
    from whisper_tpu_torch.model.quant import quantize_decoder_weights

    params = quantize_decoder_weights(tree) if quantized else tree
    return AudioEncoder(params, cfg), TextDecoder(params, cfg)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_encoder_and_decoder_logits_match_the_port(both, quantized):
    from whisper_tpu_torch.model.decoder import KVCache, decode_step, init_cache
    from whisper_tpu_torch.model.encoder import encode
    from whisper_tpu_torch.model.quant import init_quant_cache

    cfg, tree = both
    sp = Special(TINY["n_vocab"])
    enc_p, dec_p = _port_parts(cfg, tree, quantized)
    ref = Reference(tree, TINY, bits=8 if quantized else None)
    mel = window(log_mel(make_bank(6, 20.0), TINY["n_mels"], "cpu"), 0)
    with torch.inference_mode():
        out = encode(enc_p, mel[None], quantize_kv=quantized)
    cross = ref.encode(mel)
    d = TINY["n_state"] // TINY["n_head"]
    if not quantized:
        ck = out.cross_k[0, 0].transpose(-1, -2) * d ** 0.25  # (H, T, D), unscaled
        assert torch.allclose(ck, cross[0][0], atol=2e-4, rtol=1e-3)
    tokens = sp.sot_sequence("en") + [sp.beg + 3, 1200, 887, sp.beg + 40, sp.beg + 40, 15]
    with torch.inference_mode():
        if quantized:
            cache = KVCache(*init_quant_cache(cfg, 1, "cpu", ctx=32))
        else:
            cache = init_cache(cfg, 1, torch.float32, "cpu", ctx=32)
        lp, _ = decode_step(dec_p, torch.tensor([tokens]), 0, cache, out.cross_k, out.cross_v)
    lr = ref.logits(tokens, cross)
    err = (lp[0] - lr).abs().max().item()
    assert err < (2e-2 if quantized else 2e-3), err
    assert torch.equal(lp[0].argmax(-1), lr.argmax(-1))
