"""The whole slice: one synthetic GGML checkpoint through both packages'
load_model + BatchTranscriber.transcribe_batch gives identical results."""

import numpy as np
import pytest
import torch

from whisper_tpu.decoding.task import DecodingOptions as JaxOptions
from whisper_tpu.model.load import load_model as jax_load_model
from whisper_tpu.parallel.serving import BatchTranscriber as JaxTranscriber
from whisper_tpu_torch.decoding.task import DecodingOptions, decode_full
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.parallel.serving import BatchTranscriber

from fixtures import micro_config, synthetic_audio, write_synthetic_ggml


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "micro.bin"
    write_synthetic_ggml(path, micro_config(), seed=9)
    audios = [synthetic_audio(16000 * s, seed=s) for s in (1, 2)]
    return (jax_load_model(str(path), use_native=False), load_model(str(path), device="cpu"),
            audios)


@pytest.mark.parametrize("without_timestamps", [True, False])
def test_transcribe_batch_matches_jax(models, without_timestamps):
    jax_model, model, audios = models
    kw = dict(sample_len=20, without_timestamps=without_timestamps)
    ref = JaxTranscriber(jax_model, 2, options=JaxOptions(**kw)).transcribe_batch(audios)
    out = BatchTranscriber(model, 2, options=DecodingOptions(**kw)).transcribe_batch(audios)
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert o.tokens == r.tokens and o.text == r.text
        assert abs(o.no_speech_prob - r.no_speech_prob) < 1e-4
        assert abs(o.avg_logprob - r.avg_logprob) < 1e-3
    assert set(model.timers.totals) >= {"load", "mel", "encode", "decode"}


def test_unported_routes_raise(models):
    _, model, audios = models
    with pytest.raises(NotImplementedError):
        BatchTranscriber(model, 2, mesh=object())
    # best_of groups are ported: the host loop decodes each stream's samples
    results = BatchTranscriber(model, 2, options=DecodingOptions(
        temperature=0.5, best_of=2, sample_len=8)).transcribe_batch(audios)
    assert len(results) == 2 and all(r.temperature == 0.5 for r in results)
    with pytest.raises(ValueError):  # best_of is not for greedy decoding
        decode_full(model.decoder, model.vocab, None, None, DecodingOptions(best_of=3))
    with pytest.raises(ValueError):
        BatchTranscriber(model, 3).transcribe_batch(audios)
