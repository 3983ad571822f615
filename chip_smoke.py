#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (whisper_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed on its own lines; any failure raises, and the script
then exits non-zero without the final "ok" line:

1. device: a CUDA card is required (no CPU fallback); prints its name and
   power limit as nvidia-smi reports them.
2. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a).
3. kernel: the flash_attention kernel (K1) against its plain PyTorch version
   on the card, at the encoder's main-path shape and at causal and ragged
   shapes, with CUDA-event times taken in turns (plain, kernel, kernel, plain).
4. parity: a small f32 checkpoint transcribed on the CPU (plain attention)
   and on the card (the kernel); encoder output, first-step logits and
   greedy tokens must agree.
5. main path: a synthetic large-v3 checkpoint (random weights from a seed),
   loaded in bf16 on the card, transcribes a batch of 8 30 s clips through
   load_model + BatchTranscriber.transcribe_batch, with timestamps.

It imports nothing of jax. TF32 is switched off for matmuls and cuDNN
convolutions, so the f32 comparisons are full f32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from whisper_tpu.config import PRESETS, WhisperConfig
from whisper_tpu.io.ggml import tensor_schema, write_ggml
from whisper_tpu_torch.decoding.task import DecodingOptions
from whisper_tpu_torch.frontend.mel import mel_filter_bank
from whisper_tpu_torch.kernels import build
from whisper_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference
from whisper_tpu_torch.model.decoder import decode_step, init_cache
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.parallel.serving import BatchTranscriber

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "build" / "synthetic"
SAMPLE_RATE = 16000

# Tolerances (atol, rtol), kernel vs plain version on the same inputs; an
# element passes when |kernel - plain| <= atol + rtol * |plain|:
# * f32: both compute f32 scores and softmax; only the order of the sums over
#   up to 1500 keys differs (online softmax vs one pass).
# * bf16: the plain version rounds the normalised probabilities to bf16 before
#   the PV product, the kernel keeps them in f32; both round the output to
#   bf16, so they may differ by an ulp or two of the output: up to 2^-7 of
#   its magnitude (rtol), or 1e-2 near zero (atol). Causal rows that see
#   few keys reach |out| ~ 4, where one ulp is 2^-6.
K1_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 2 ** -6)}
# CPU vs card at f32 (same bound the CPU tests hold the port to against
# JAX): GEMM and convolution sums run in another order on the two devices.
PARITY_ATOL = 3e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic_audio(n_samples: int, seed: int) -> np.ndarray:
    """Deterministic band-limited pseudo-speech: drifting harmonics."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SAMPLE_RATE
    audio = np.zeros(n_samples, dtype=np.float64)
    for f0 in (110.0, 220.0, 330.0, 550.0, 1200.0):
        phase = rng.uniform(0, 2 * np.pi)
        drift = 1.0 + 0.02 * np.sin(2 * np.pi * 0.5 * t + phase)
        audio += rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * f0 * drift * t + phase)
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t))
    return (audio * envelope * 0.3).astype(np.float32)


def write_checkpoint(path: Path, cfg: WhisperConfig, seed: int, scale: float) -> None:
    """Random GGML checkpoint: LN weights 1, biases 0, every other tensor
    scale * N(0, 1), drawn tensor by tensor and stored in the header's type."""
    rng = np.random.default_rng(seed)
    wtype = np.float16 if cfg.f16 == 1 else np.float32
    tensors = {}
    for name, (shape, kind) in tensor_schema(cfg).items():
        if name.endswith("ln.weight") or name.endswith("ln_post.weight"):
            arr = np.ones(shape, np.float32)
        elif name.endswith(".bias"):
            arr = np.zeros(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        tensors[name] = arr.astype(wtype if kind == "w" else np.float32)
    tokens = [f"<t{i}>".encode() for i in range(min(cfg.n_vocab, 51864))]
    tokens[220] = b" "  # a space token, for blank suppression
    tmp = path.with_name(path.name + ".tmp")
    write_ggml(str(tmp), cfg, mel_filter_bank(cfg.n_mels), tokens, tensors)
    tmp.replace(path)


def cuda_ms(fn, iters: int) -> float:
    fn()  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN: f32 comparisons are full f32")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_library("flash_attention")
    seconds, report = build.build_info["flash_attention"]
    log(f"[build] flash_attention.cu: nvcc {seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_kernel(card: str) -> dict:
    """K1 vs its plain version; returns the main-path bf16 row."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (batch, heads, tq, tk, causal, dtype)
        (8, 20, 1500, 1500, False, torch.bfloat16),  # encoder main path, large-v3 b8
        (8, 20, 1500, 1500, False, torch.float32),
        (2, 20, 448, 448, True, torch.bfloat16),
        (2, 20, 448, 448, True, torch.float32),
        (2, 20, 100, 300, False, torch.bfloat16),
        (2, 20, 100, 300, False, torch.float32),
    ]
    main = None
    for b, h, tq, tk, causal, dtype in cases:
        q, k, v = (torch.randn(b, h, t, 64, device="cuda", generator=gen).to(dtype)
                   for t in (tq, tk, tk))
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, causal=causal)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        atol, rtol = K1_TOL[dtype]
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        iters = 20 if tq * tk > 1e6 else 50
        plain = lambda: flash_attention_reference(q, k, v, causal=causal)  # noqa: E731
        kern = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        t_plain1, t_k1, t_k2, t_plain2 = (cuda_ms(plain, iters), cuda_ms(kern, iters),
                                          cuda_ms(kern, iters), cuda_ms(plain, iters))
        ms, plain_ms = (t_k1 + t_k2) / 2, (t_plain1 + t_plain2) / 2
        tflops = 4 * b * h * tq * tk * 64 / (ms * 1e-3) / 1e12
        log(f"[kernel] flash_attention ({b * h}, {tq}x{tk}, 64) {str(dtype)[6:]} causal={causal}: "
            f"max_abs_err {err:.3e} (atol {atol:.0e}, rtol {rtol:.1e}); kernel {ms:.4f} ms "
            f"({t_k1:.4f}, {t_k2:.4f}), plain {plain_ms:.4f} ms ({t_plain1:.4f}, {t_plain2:.4f}); "
            f"kernel {tflops:.1f} TFLOP/s (dense, no causal skip); {card}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version: "
                                 f"max_abs_err {err}, atol {atol}, rtol {rtol}")
        if main is None:
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return main


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def phase_parity(card: str) -> None:
    # tests/fixtures.py's tiny_config, widened to 128 so that d_head is 64,
    # the one head width of every Whisper size and of the kernel.
    cfg = dataclasses.replace(PRESETS["tiny.en"], n_audio_state=128, n_audio_head=2,
                              n_audio_layer=2, n_text_state=128, n_text_head=2,
                              n_text_layer=2, f16=0)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / "tiny-d128-f32-seed7.bin"
    if not path.exists():
        write_checkpoint(path, cfg, seed=7, scale=0.08)
    models = {dev: load_model(str(path), device=dev, dtype=torch.float32)
              for dev in ("cpu", "cuda")}
    audios = [synthetic_audio(SAMPLE_RATE * s, seed=s) for s in (7, 30)]
    options = DecodingOptions(sample_len=48, without_timestamps=False)
    bts = {dev: BatchTranscriber(m, 2, options=options) for dev, m in models.items()}

    with torch.inference_mode():
        mel = bts["cpu"]._mel_batch(audios)
        enc = {dev: models[dev].encoder(mel.to(dev)) for dev in models}
        for name in ("hidden", "cross_k", "cross_v"):
            err = (getattr(enc["cpu"], name) - getattr(enc["cuda"], name).cpu()).abs().max().item()
            log(f"[parity] encoder {name}: cpu vs cuda max_abs_err {err:.3e} (tol {PARITY_ATOL:.0e})")
            if not err <= PARITY_ATOL:
                raise AssertionError(f"encoder {name} differs between cpu and cuda: {err}")
        sot = torch.full((2, 1), models["cpu"].vocab.token_sot)
        logits = {}
        for dev, m in models.items():
            cache = init_cache(cfg, 2, torch.float32, dev, ctx=8)
            logits[dev], _ = decode_step(m.decoder, sot.to(dev), 0, cache,
                                         enc[dev].cross_k, enc[dev].cross_v)
        err = (logits["cpu"] - logits["cuda"].cpu()).abs().max().item()
        log(f"[parity] first-step logits: cpu vs cuda max_abs_err {err:.3e} (tol {PARITY_ATOL:.0e})")
        if not err <= PARITY_ATOL:
            raise AssertionError(f"first-step logits differ between cpu and cuda: {err}")

    launches0 = flash_attention.launches
    results = {dev: bt.transcribe_batch(audios) for dev, bt in bts.items()}
    if flash_attention.launches - launches0 != cfg.n_audio_layer:
        raise AssertionError("the cuda encoder did not run flash_attention once per layer")
    for i, (c, g) in enumerate(zip(results["cpu"], results["cuda"])):
        if c.tokens != g.tokens:
            j = _first_divergence(c.tokens, g.tokens)
            # the logit margin between the two choices, at the step they part
            init = [models["cpu"].vocab.token_sot] + c.tokens[:j]
            for dev, m in models.items():
                toks = torch.tensor([init]).to(dev)
                cache = init_cache(cfg, 1, torch.float32, dev, ctx=len(init))
                lg, _ = decode_step(m.decoder, toks, 0, cache, enc[dev].cross_k[:, i:i + 1],
                                    enc[dev].cross_v[:, i:i + 1])
                a, b = c.tokens[j:j + 1] or [0], g.tokens[j:j + 1] or [0]
                log(f"[parity] stream {i} step {j}: {dev} logit[{a[0]}] - logit[{b[0]}] = "
                    f"{(lg[0, -1, a[0]] - lg[0, -1, b[0]]).item():.3e}")
            raise AssertionError(f"greedy tokens differ between cpu and cuda in stream {i}")
    n_tok = sum(len(r.tokens) for r in results["cpu"])
    log(f"[parity] greedy tokens identical on cpu and cuda: {n_tok} tokens over 2 streams, "
        f"timestamps on; {card}")


def phase_main_path(card: str) -> int:
    cfg = PRESETS["large-v3"]
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / "large-v3-f16-seed0.bin"
    t0 = time.perf_counter()
    if not path.exists():
        write_checkpoint(path, cfg, seed=0, scale=0.02)
    log(f"[main] synthetic large-v3 checkpoint {path.stat().st_size / 1e9:.2f} GB "
        f"ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model = load_model(str(path), dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] load_model bf16 on cuda: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    audios = [synthetic_audio(SAMPLE_RATE * 30, seed=100 + i) for i in range(8)]
    bt = BatchTranscriber(model, 8, options=DecodingOptions(sample_len=64,
                                                             without_timestamps=False))
    launches = None
    for run in (1, 2):
        model.timers.totals.clear()
        model.timers.counts.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        results = bt.transcribe_batch(audios)
        wall = time.perf_counter() - t0
        n_launch = flash_attention.launches
        if run == 1:
            launches = n_launch
        peak = torch.cuda.max_memory_allocated()
        tm = model.timers.totals
        n_tok = sum(len(r.tokens) for r in results)
        log(f"[main] run {run}: 8 x 30 s, bf16, greedy, timestamps, sample_len 64: "
            f"mel {tm['mel'] * 1e3:.1f} ms, encode {tm['encode'] * 1e3:.1f} ms, "
            f"decode {tm['decode'] * 1e3:.1f} ms, total {wall * 1e3:.1f} ms; "
            f"{n_tok} tokens; peak {peak / 1e9:.2f} GB; flash_attention launches {n_launch}; {card}")
        if len(results) != 8:
            raise AssertionError(f"expected 8 results, got {len(results)}")
        for r in results:
            if not all(0 <= t < cfg.n_vocab for t in r.tokens):
                raise AssertionError(f"token out of the vocab: {r.tokens}")
            if not (math.isfinite(r.avg_logprob) and math.isfinite(r.no_speech_prob)):
                raise AssertionError(f"non-finite result: {r}")
        if n_launch != cfg.n_audio_layer:
            raise AssertionError(f"flash_attention launched {n_launch} times in one "
                                 f"encode, expected {cfg.n_audio_layer}")
    log(f"[main] stream 0: {results[0].tokens[:12]}... avg_logprob "
        f"{results[0].avg_logprob:.4f} no_speech_prob {results[0].no_speech_prob:.4f}")
    return launches


def main() -> None:
    card = phase_device()
    phase_build()
    k1 = phase_kernel(card)
    phase_parity(card)
    launches = phase_main_path(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "whisper_tpu_torch/csrc/flash_attention.cu",
        "replaces": "whisper_tpu/kernels/flash_attention.py:141",
        "launches": launches, **k1}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
