"""The throughput benchmark: audio seconds transcribed per second (RTF).

Port of ``whisper_tpu/utils/benchmark.py``'s lockstep benchmark on one
device: ``make_serving_step`` (one 30 s window -> log-mel -> broadcast to
the batch -> encoder, W8A8 when its weights are int8, with an int8 or bf16
cross memory -> a greedy decode of ``decode_tokens`` tokens with timestamp
rules and an int8 or bf16 self cache, or with ``beam_size=k`` the device
beam over batch·k cache rows and a group-shared cross memory), its
parameter preparation (``prepare_serving_params``), and ``run_benchmark``'s
timing loop, guarded by ``config.check_serving_hbm`` before anything is
allocated.

    python -m whisper_tpu_torch.utils.benchmark [--device cuda]

prints one JSON line with bench.py's keys, configured by bench.py's knobs
for its default mode (BENCH_MODEL, BENCH_BATCH, BENCH_BEAM, BENCH_KV,
BENCH_WQ, BENCH_ENC, BENCH_DTYPE, BENCH_SECONDS), or with BENCH_MODE=engine
for ``run_engine_benchmark`` (the SlotEngine, or with BENCH_BEAM the
BeamSlotEngine, draining staggered streams: BENCH_BATCH slots,
BENCH_STREAMS, BENCH_CHUNK, BENCH_KV, BENCH_ENC, BENCH_PRESTAGED,
BENCH_BUCKET, BENCH_SCHEDULE, BENCH_SECONDS). The metric name marks the
backend (``rtf_torch_...``). What the port does not have yet exits
non-zero naming its ROADMAP item: BENCH_MODE=spec and BENCH_DRAFT (item 14).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import N_SAMPLES_PER_CHUNK, PRESETS, WhisperConfig, check_serving_hbm
from ..decoding.device_beam import beam_decode_device
from ..decoding.device_loop import build_masks, decode_segment_device
from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
from ..io.ggml import read_ggml_config
from ..kernels.launches import kernel_launches
from ..model.decoder import KVCache, init_cache
from ..model.encoder import encode
from ..errors import WhisperError
from ..model.load import WhisperModel, load_model, random_model
from ..model.params import Params
from ..model.quant import (fuse_decoder_qkv, init_quant_cache, quantize_decoder_weights,
                           quantize_encoder_weights)


def prepare_serving_params(params: Params, weight_dtype: str = "int8",
                           enc_dtype: str = "int8") -> Params:
    """The serving tree, in run_benchmark's order: int8 decoder weights,
    then the W8A8 encoder's int8 weights, then the fused decoder QKV
    (quantized first, so per-channel scales concatenate exactly). A dtype
    other than "int8" leaves that part in the model dtype. Rebuild the
    modules from the result with ``WhisperModel.with_params``."""
    if weight_dtype == "int8":
        params = quantize_decoder_weights(params)
    if enc_dtype == "int8":
        params = quantize_encoder_weights(params)
    return fuse_decoder_qkv(params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serving_ctx(cfg: WhisperConfig, decode_tokens: int) -> int:
    """Self-cache positions of the serving step: the initial tokens (SOT,
    and language and task on a multilingual model), the decoded tokens and 8
    spare."""
    return (3 if cfg.is_multilingual else 1) + decode_tokens + 8


def make_serving_step(model: WhisperModel, batch: int, decode_tokens: int, kv_dtype: str,
                      beam_size: Optional[int] = None
                      ) -> Callable[[np.ndarray], Tuple[torch.Tensor, torch.Tensor]]:
    """``step(audio) -> (tokens (batch, decode_tokens), lengths (batch,))``
    for one 30 s clip broadcast to ``batch`` rows. ``kv_dtype`` "int8"
    makes the cross memory and the self cache int8; "bfloat16" keeps both
    bf16. With ``beam_size=k`` the decode is the device beam, over a self
    cache of batch·k rows and the cross memory at batch ``batch``
    (group-shared), and the step returns JAX's ``(fin_tokens (batch, k,
    decode_tokens), fin_count (batch,))``. Stage wall times (mel, encode,
    decode; each ends in a device synchronise) go to ``model.timers``."""
    if kv_dtype not in ("int8", "bfloat16"):
        raise ValueError(f"kv_dtype must be 'int8' or 'bfloat16', got {kv_dtype!r}")
    cfg, vocab, device = model.config, model.vocab, model.device
    n_frames = 2 * cfg.n_audio_ctx
    sup_mask, blank_mask = build_masks(vocab, device)
    init = [vocab.token_sot]
    if cfg.is_multilingual:
        init += [vocab.language_token("en"), vocab.token_transcribe]
    k = beam_size or 1
    init_tokens = torch.tensor([init] * (batch * k), dtype=torch.long, device=device)
    seg_ctx = serving_ctx(cfg, decode_tokens)

    def step(audio: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            with model.timers.stage("mel"):
                a = torch.as_tensor(np.asarray(audio, dtype=np.float32)).to(device)
                mel = log_mel_spectrogram(a, model.filters, frame_count(N_SAMPLES_PER_CHUNK))
                mel_b = mel_window(mel, 0, n_frames)[None].expand(batch, -1, -1)
                _sync(device)
            with model.timers.stage("encode"):
                enc = encode(model.encoder, mel_b, quantize_kv=kv_dtype == "int8")
                _sync(device)
            with model.timers.stage("decode"):
                if kv_dtype == "int8":
                    cache = KVCache(*init_quant_cache(cfg, batch * k, device, ctx=seg_ctx))
                else:
                    cache = init_cache(cfg, batch * k, torch.bfloat16, device, ctx=seg_ctx)
                if beam_size:
                    out = beam_decode_device(
                        model.decoder, init_tokens, len(init), 0, cache, enc.cross_k,
                        enc.cross_v, sup_mask, blank_mask, beam_size=k,
                        sample_len=decode_tokens)
                    toks, lengths = out[2], out[5]
                else:
                    toks, lengths, _, _ = decode_segment_device(
                        model.decoder, init_tokens, len(init), 0, cache, enc.cross_k,
                        enc.cross_v, sup_mask, blank_mask, sample_len=decode_tokens,
                        use_timestamps=True)
                _sync(device)
        return toks, lengths

    return step


WINDOW_SEC = 30.0
_WAITS_FOR = {"spec": "parallel/spec_engine.py and decoding/speculative.py (ROADMAP item 14)",
              "draft": "parallel/spec_engine.py (ROADMAP item 14)"}


def card_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None on the
    CPU or when nvidia-smi cannot be run)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def run_benchmark(
    model_path: Optional[str] = None,
    model_name: str = "large-v3",
    seconds: int = 120,
    batch: int = 8,
    dtype: str = "bfloat16",
    decode_tokens: int = 64,
    kv_dtype: str = "int8",      # quantized cross memory / KV cache
    weight_dtype: str = "int8",  # quantized decoder weights
    beam_size: Optional[int] = None,  # the device beam instead of greedy
    aot_path: Optional[str] = None,
    enc_dtype: str = "int8",     # W8A8 encoder matmuls
    device: torch.device | str = "cuda",
    budget_bytes: Optional[int] = None,
) -> dict:
    """Lockstep serving throughput: one warm-up step, then timed steps until
    ``seconds`` (less the warm-up, at least 5 s) are spent, each ending with
    the tokens on the host. RTF = steps · batch · 30 s / wall. Runs on the
    card unless ``device`` is the CPU; the memory guard runs before any
    allocation (``budget_bytes`` overrides the card's budget; on the CPU
    without it nothing is checked). Returns bench.py's keys."""
    if aot_path:
        raise WhisperError("an ahead-of-time serving artifact needs a torch export of the "
                           "serving step (the JAX package's utils/aot.py), which is not "
                           "ported yet")
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise WhisperError("run_benchmark runs on a CUDA card and none is available; "
                           "pass device='cpu' to run on the CPU")
    cfg = read_ggml_config(model_path) if model_path else PRESETS[model_name]
    estimate = check_serving_hbm(
        cfg, batch, beam=beam_size or 1, ctx=serving_ctx(cfg, decode_tokens),
        kv_dtype_bytes=1 if kv_dtype == "int8" else 2,
        what=f"run_benchmark(batch={batch}, beam={beam_size}, kv={kv_dtype})",
        budget_bytes=budget_bytes, device=device)

    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if model_path:
        model = load_model(model_path, device=device, dtype=tdtype)
    else:
        model = random_model(cfg, seed=0, dtype=tdtype, device=device, on_device=True)
    model = model.with_params(prepare_serving_params(model.params, weight_dtype, enc_dtype))
    step = make_serving_step(model, batch, decode_tokens, kv_dtype, beam_size)
    audio = (np.random.default_rng(0).standard_normal(16000 * 30).astype(np.float32) * 0.1)

    def one_batch():
        toks, lengths = step(audio)
        return toks.cpu().numpy(), lengths.cpu().numpy()

    t0 = time.perf_counter()
    one_batch()
    warmup = time.perf_counter() - t0
    model.timers.totals.clear()  # the stage walls of the timed steps only
    model.timers.counts.clear()

    launches0 = kernel_launches()
    iters = 0
    t0 = time.perf_counter()
    deadline = t0 + max(5.0, seconds - warmup)
    while time.perf_counter() < deadline:
        one_batch()
        iters += 1
    wall = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    rtf = iters * batch * WINDOW_SEC / wall if wall > 0 else 0.0
    on_card = device.type == "cuda"
    return {
        "metric": f"rtf_torch_{cfg.model_type}_b{batch}_"
        + (f"beam{beam_size}x" if beam_size else "greedy")
        + f"{decode_tokens}"
        + ("_kvint8" if kv_dtype == "int8" else "")
        + ("_wint8" if weight_dtype == "int8" else "")
        + ("_eint8" if enc_dtype == "int8" else ""),
        "value": rtf,
        "unit": "audio_sec/sec/chip",
        "vs_baseline": None,  # no baseline on the card yet
        "detail": {
            "model": cfg.model_type,
            "weights": model_path or f"random (seed 0, {model_name})",
            "batch": batch,
            "beam_size": beam_size,
            "dtype": dtype,
            "kv_dtype": kv_dtype,
            "weight_dtype": weight_dtype,
            "enc_dtype": enc_dtype,
            "decode_tokens": decode_tokens,
            "iters": iters,
            "wall_s": wall,
            "warmup_s": warmup,
            "device": str(device),
            "card": torch.cuda.get_device_name(device) if on_card else None,
            "nvidia_smi": card_line(device),
            "torch": torch.__version__,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(device) if on_card else None,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(device) if on_card else None,
            "hbm_estimate": estimate,
            "stages_s": dict(model.timers.totals),
            "kernel_launches": launches,  # over the timed steps
        },
    }


def engine_streams(n_streams: int) -> list:
    """The engine bench's streams: int16 PCM of 24, 27 and 30 s in turn
    (ragged finishes force refills mid-decode), from ``default_rng(0)``, as
    the JAX package's engine bench draws them."""
    rng = np.random.default_rng(0)
    secs = [24.0, 27.0, 30.0]
    return [np.clip(rng.standard_normal(int(16000 * secs[i % 3])) * 0.1 * 32768,
                    -32768, 32767).astype(np.int16) for i in range(n_streams)]


def run_engine_benchmark(
    model_name: str = "large-v3",
    n_slots: int = 64,
    n_streams: Optional[int] = None,
    chunk_steps: int = 32,
    quantize: bool = True,
    max_new_tokens: int = 64,
    seconds: int = 120,
    prestage: bool = False,
    enc_int8: bool = False,
    max_bucket: Optional[int] = None,
    schedule: Optional[str] = None,
    beam_size: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> dict:
    """Continuous-batching serving throughput: a ``SlotEngine`` of
    ``n_slots`` (with ``beam_size`` a ``BeamSlotEngine`` of ``n_slots``
    groups of that many rows; random ``model_name`` weights from seed 0,
    bf16; with ``quantize`` int8 decoder weights and int8 pools) drains
    ``n_streams``
    (default 2 × slots) streams of ``engine_streams``: one warm-up wave,
    then timed waves until ``seconds`` are spent (at least one). RTF =
    audio seconds drained per wall second. ``prestage`` puts the PCM on the
    card before the timed run; ``enc_int8`` runs the admission encodes
    W8A8; ``max_bucket`` caps the admission buckets. The engine's memory
    guard runs at its construction. Returns bench.py's keys."""
    from ..decoding.task import DecodingOptions
    from ..parallel.beam_engine import BeamSlotEngine
    from ..parallel.engine import SlotEngine

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise WhisperError("run_engine_benchmark runs on a CUDA card and none is available; "
                           "pass device='cpu' to run on the CPU")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    cfg = PRESETS[model_name]
    model = random_model(cfg, seed=0, dtype=torch.bfloat16, device=device, on_device=True)
    model = model.with_params(prepare_serving_params(
        model.params, "int8" if quantize else "bfloat16", "int8" if enc_int8 else "bfloat16"))
    n_streams = n_streams or 2 * n_slots
    audios = engine_streams(n_streams)
    total_audio = sum(len(a) for a in audios) / 16000.0
    if prestage:
        audios = [torch.from_numpy(a).to(device) for a in audios]
        _sync(device)
    buckets = None
    if max_bucket:
        buckets = tuple(b for b in (32, 16, 8, 4, 2, 1) if b <= max_bucket)
    engine = (BeamSlotEngine if beam_size else SlotEngine)(
        model, n_slots=n_slots, chunk_steps=chunk_steps,
        options=DecodingOptions(without_timestamps=False, beam_size=beam_size),
        max_new_tokens=max_new_tokens, quantize=quantize, admit_buckets=buckets,
        **({"schedule": schedule} if schedule else {}))
    # Warm-up: a full first wave plus a refill wave, then a fresh pool.
    t0 = time.perf_counter()
    engine.transcribe_many(audios[: min(len(audios), n_slots + 16)])
    _sync(device)
    warmup = time.perf_counter() - t0
    engine._state = None
    engine._cross_pool_k = engine._cross_pool_v = None

    launches0 = kernel_launches()
    waves = 0
    audio_done = 0.0
    steps = dict.fromkeys(("decode_steps", "graph_steps", "graph_captures"), 0)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        results = engine.transcribe_many(audios)
        waves += 1
        audio_done += total_audio
        for k in steps:
            steps[k] += engine.stats.get(k, 0)
        if time.perf_counter() >= deadline:
            break
    wall = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    return {
        "metric": f"rtf_torch_{cfg.model_type}_engine_s{n_slots}_q{n_streams}"
        + (f"_beam{beam_size}" if beam_size else "")
        + ("_int8" if quantize else "") + ("_eint8" if enc_int8 else "")
        + ("_prestaged" if prestage else ""),
        "value": audio_done / wall,
        "unit": "audio_sec/sec/chip",
        "vs_baseline": None,  # no baseline on the card yet
        "detail": {
            "model": cfg.model_type,
            "weights": f"random (seed 0, {model_name})",
            "n_slots": n_slots,
            "n_streams": n_streams,
            "chunk_steps": chunk_steps,
            "beam_size": beam_size,
            "quantize": quantize,
            "enc_int8": enc_int8,
            "prestage": prestage,
            "schedule": engine.schedule,
            "admit_buckets": list(engine._ADMIT_BUCKETS),
            "max_new_tokens": engine.max_new,
            "wall_s": wall,
            "warmup_s": warmup,
            "waves": waves,
            "n_results": sum(r is not None for r in results),
            "tokens_last_wave": sum(len(r.tokens) for r in results if r is not None),
            "stats": dict(engine.stats),  # the last timed wave's
            # decode steps over the timed waves, those that replayed the
            # engine's step graph, and the graphs captured
            "steps": steps,
            # K7's forked rows over the timed waves' steps (the beam engine's)
            "forks": engine.fork_stats() if beam_size else None,
            "device": str(device),
            "card": torch.cuda.get_device_name(device) if on_card else None,
            "nvidia_smi": card_line(device),
            "torch": torch.__version__,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(device) if on_card else None,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(device) if on_card else None,
            "hbm_estimate": engine.hbm_estimate,
            "kernel_launches": launches,  # over the timed waves
        },
    }


def bench_config_from_env(env: Mapping[str, str]) -> dict:
    """run_benchmark's keyword arguments from bench.py's knobs for its
    default mode: BENCH_MODEL (large-v3), BENCH_BATCH (64, or 48 with a
    beam), BENCH_BEAM, BENCH_KV, BENCH_WQ, BENCH_ENC (int8 each),
    BENCH_DTYPE (bfloat16) and BENCH_SECONDS (120). BENCH_MODE=engine is
    ``engine_config_from_env``'s; BENCH_MODE=spec raises WhisperError naming
    the modules it waits for."""
    mode = env.get("BENCH_MODE")
    if mode:
        if mode == "engine":
            raise WhisperError("BENCH_MODE=engine is configured by engine_config_from_env")
        if mode not in _WAITS_FOR:
            raise WhisperError(f"unknown BENCH_MODE={mode!r}")
        raise WhisperError(f"BENCH_MODE={mode} needs {_WAITS_FOR[mode]}, which the port "
                           "does not have yet")
    beam = env.get("BENCH_BEAM")
    return dict(
        model_name=env.get("BENCH_MODEL", "large-v3"),
        batch=int(env.get("BENCH_BATCH", "48" if beam else "64")),
        beam_size=int(beam) if beam else None,
        seconds=int(env.get("BENCH_SECONDS", "120")),
        dtype=env.get("BENCH_DTYPE", "bfloat16"),
        kv_dtype=env.get("BENCH_KV", "int8"),
        weight_dtype=env.get("BENCH_WQ", "int8"),
        enc_dtype=env.get("BENCH_ENC", "int8"),
    )


def engine_config_from_env(env: Mapping[str, str]) -> dict:
    """run_engine_benchmark's keyword arguments from bench.py's knobs for
    BENCH_MODE=engine, with its engine defaults: BENCH_MODEL (large-v3),
    BENCH_BEAM (greedy without it), BENCH_BATCH slots (64, or 32 beam
    groups), BENCH_STREAMS (2 × slots), BENCH_CHUNK (32, or 16 with a
    beam), BENCH_KV (int8: int8 pools and decoder weights), BENCH_ENC (int8
    for W8A8 encodes; off by default), BENCH_PRESTAGED=1, BENCH_BUCKET,
    BENCH_SCHEDULE, BENCH_SECONDS (120). BENCH_DRAFT raises WhisperError
    naming the ROADMAP item that ports it."""
    if env.get("BENCH_DRAFT"):
        raise WhisperError(f"BENCH_MODE=engine with BENCH_DRAFT needs {_WAITS_FOR['draft']}, "
                           "which the port does not have yet")
    beam = env.get("BENCH_BEAM")
    return dict(
        model_name=env.get("BENCH_MODEL", "large-v3"),
        beam_size=int(beam) if beam else None,
        n_slots=int(env.get("BENCH_BATCH", "32" if beam else "64")),
        n_streams=int(env["BENCH_STREAMS"]) if env.get("BENCH_STREAMS") else None,
        chunk_steps=int(env.get("BENCH_CHUNK", "16" if beam else "32")),
        quantize=env.get("BENCH_KV", "int8") == "int8",
        seconds=int(env.get("BENCH_SECONDS", "120")),
        prestage=env.get("BENCH_PRESTAGED", "") == "1",
        enc_int8=env.get("BENCH_ENC", "") == "int8",
        max_bucket=int(env["BENCH_BUCKET"]) if env.get("BENCH_BUCKET") else None,
        schedule=env.get("BENCH_SCHEDULE") or None,
    )


def main(argv=None) -> int:
    """Print one JSON line: the benchmark's result, or on a refused
    configuration (WhisperError) a line with value 0 and the error, and
    exit 1."""
    import argparse

    parser = argparse.ArgumentParser(prog="python -m whisper_tpu_torch.utils.benchmark")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    try:
        if os.environ.get("BENCH_MODE") == "engine":
            result = run_engine_benchmark(device=args.device,
                                          **engine_config_from_env(os.environ))
        else:
            result = run_benchmark(device=args.device, **bench_config_from_env(os.environ))
    except WhisperError as e:
        print(json.dumps({"metric": "rtf_torch_refused", "value": 0.0,
                          "unit": "audio_sec/sec/chip", "vs_baseline": None,
                          "detail": {"error": str(e)}}))
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
