#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (whisper_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed on its own lines; any failure raises, and the script
then exits non-zero without the final "ok" line:

1. device: a CUDA card is required (no CPU fallback); prints its name and
   power limit as nvidia-smi reports them.
2. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a), one nvcc
   process per source, all started together.
3. kernel: the flash_attention kernel (K1) against its plain PyTorch version
   on the card, at the encoder shapes of both main paths (large-v3 at batch
   8 and 64) and at causal and ragged shapes, with CUDA-event times taken in
   turns (plain, kernel, kernel, plain).
4. parity: a small f32 checkpoint transcribed on the CPU (plain attention)
   and on the card (the kernel); encoder output, first-step logits and
   greedy tokens must agree.
5. main path: a synthetic large-v3 checkpoint (random weights from a seed),
   loaded in bf16 on the card, transcribes a batch of 8 30 s clips through
   load_model + BatchTranscriber.transcribe_batch, with timestamps.
6. int8 kernels: fused_quant (K2 "act", K3 "ln" and "gelu") and
   cross_attention_int8 (K4, cross and causal self) against their plain
   versions at the int8 main path's shapes, timed in turns as in phase 3;
   a planted fault (the tanh GELU kernel against the erf plain version) must
   fail the fused_quant bound.
7. int8 parity: phase 4's checkpoint prepared for serving
   (prepare_serving_params: int8 decoder, W8A8 encoder, fused QKV) runs
   make_serving_step(kv_dtype="int8") on the CPU (plain versions) and on the
   card (the kernels); first-step logits and greedy tokens must agree.
8. int8 main path: phase 5's large-v3 model prepared the same way runs
   make_serving_step at batch 64, 64 tokens, int8 cross memory and cache,
   twice, with the launch count of every kernel checked per step.

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
from whisper_tpu_torch.frontend.mel import (frame_count, log_mel_spectrogram, mel_filter_bank,
                                            mel_window)
from whisper_tpu_torch.kernels import build
from whisper_tpu_torch.kernels import fused_quant
from whisper_tpu_torch.kernels.cross_attention_int8 import (cross_attention_int8,
                                                            cross_attention_int8_reference)
from whisper_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference
from whisper_tpu_torch.kernels.ops import gelu, layer_norm
from whisper_tpu_torch.model.decoder import KVCache, decode_step, init_cache
from whisper_tpu_torch.model.encoder import encode
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.model.quant import QuantKV, init_quant_cache, quantize_act, quantize_kv
from whisper_tpu_torch.parallel.serving import BatchTranscriber
from whisper_tpu_torch.utils.benchmark import make_serving_step, prepare_serving_params

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
# K2/K3 vs the unfused plain chain: (scale rtol, max code levels apart,
# share of codes moved below). Set from the card's readings (PERF.md), not
# from the looser test_quant.py bounds, so that a wrong kernel fails:
# * "act" is only the quantizer, with IEEE division and rounding half to
#   even: bit-exact.
# * "gelu": the same f32 GELU rounded the same way; the f32 path's A-S erf
#   may sit an f32 ulp from torch's erf, which can move a code at a rounding
#   boundary by one level on a few in a million: scale within an f32 ulp,
#   one level on under 1e-4 of the codes.
# * "ln": the moments sum in another order, which may move the bf16 LN
#   output by an ulp: scale within a bf16 ulp (2^-7), one level on under
#   1e-4 of the codes.
# A tanh GELU against the erf plain version moves ~3e-3 of the codes and a
# GELU that skips the bf16 round trip ~2e-2, so both fail; phase 6 plants
# the first and checks that it is caught.
FQ_BOUNDS = {"act": (0.0, 0, 0.0), "gelu": (2 ** -23, 1, 1e-4), "ln": (2 ** -7, 1, 1e-4)}
# K4 vs quant_sdpa. Both take the same f32 logits and softmax and round the
# NORMALISED p * v_scale to bf16 (two passes, no online softmax), so only the
# order of the f32 sums differs: a bf16 output may move by one ulp (2^-7 of
# its magnitude, tighter than K1's 2^-6), an f32 one by f32 noise.
K4_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}
# int8 CPU vs card on the f32 checkpoint: any f32 difference between the
# devices (K1's sums, the convolution, the kernels' LN) can move a W8A8 code
# at a rounding boundary by a level, one quantization step of an activation,
# which moves the next product's row and more codes after it.
INT8_PARITY_ATOL = 1e-2
INT8_AGREEMENT = 0.9
KERNELS = ("flash_attention", "fused_quant", "cross_attention_int8")


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


def in_turns(plain, kern, iters: int):
    """CUDA-event times taken plain, kernel, kernel, plain; returns (kernel
    ms, plain ms, the four readings in that order)."""
    t_plain1, t_k1, t_k2, t_plain2 = (cuda_ms(plain, iters), cuda_ms(kern, iters),
                                      cuda_ms(kern, iters), cuda_ms(plain, iters))
    return (t_k1 + t_k2) / 2, (t_plain1 + t_plain2) / 2, (t_plain1, t_k1, t_k2, t_plain2)


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
    build.build_all(KERNELS)  # one nvcc per source, all at once
    log(f"[build] {len(KERNELS)} kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        seconds, report = build.build_info[name]
        log(f"[build] {name}.cu: nvcc {seconds:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"[build]   {line.strip()}")


def phase_kernel(card: str) -> dict:
    """K1 vs its plain version; returns the main-path bf16 row."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (batch, heads, tq, tk, causal, dtype)
        (8, 20, 1500, 1500, False, torch.bfloat16),  # encoder main path, large-v3 b8
        (64, 20, 1500, 1500, False, torch.bfloat16),  # int8 main path's encoder, b64
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
        iters = 5 if b * h * tq * tk > 1e9 else 20 if tq * tk > 1e6 else 50
        plain = lambda: flash_attention_reference(q, k, v, causal=causal)  # noqa: E731
        kern = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        ms, plain_ms, (t_plain1, t_k1, t_k2, t_plain2) = in_turns(plain, kern, iters)
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
        del q, k, v, out, ref, diff
    torch.cuda.empty_cache()  # the b64 plain version held ~29 GB of scores
    return main


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def tiny_checkpoint():
    """tests/fixtures.py's tiny_config, widened to 128 so that d_head is 64,
    the one head width of every Whisper size and of the kernels; f32."""
    cfg = dataclasses.replace(PRESETS["tiny.en"], n_audio_state=128, n_audio_head=2,
                              n_audio_layer=2, n_text_state=128, n_text_head=2,
                              n_text_layer=2, f16=0)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / "tiny-d128-f32-seed7.bin"
    if not path.exists():
        write_checkpoint(path, cfg, seed=7, scale=0.08)
    return cfg, path


def phase_parity(card: str) -> None:
    cfg, path = tiny_checkpoint()
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


def phase_main_path(card: str):
    """Returns (K1 launches of the first run, the bf16 large-v3 model)."""
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
    return launches, model


FQ_CASES = [  # (mode, rows, d, dtype): the int8 main path's sites, large-v3 at batch 64
    ("act", 64 * 1500, 1280, torch.bfloat16),       # attention output; hidden before cross-K/V
    ("ln", 64 * 1500, 1280, torch.bfloat16),        # LN -> QKV and LN -> MLP0
    ("gelu-erf", 64 * 1500, 5120, torch.bfloat16),  # GELU -> MLP1
    ("gelu-tanh", 2 * 1500, 5120, torch.bfloat16),  # ggml's GELU, off the main path
    ("ln", 2 * 1500, 1280, torch.float32),          # the f32 parity path (phase 7)
    ("gelu-erf", 2 * 1500, 5120, torch.float32),
]
K4_CASES = [  # (name, batch, heads, tq, keys, n_past, dtype); n_past None: cross
    ("cross", 64, 20, 1, 1500, None, torch.bfloat16),  # decode step, large-v3 b64
    ("cross-t3", 64, 20, 3, 1500, None, torch.bfloat16),  # prefill of the 3-token prompt
    ("cross-f32", 64, 20, 1, 1500, None, torch.float32),
    ("self", 64, 20, 1, 75, 40, torch.bfloat16),  # a layer of the int8 self cache
    ("self-3", 64, 20, 1, 75, 3, torch.bfloat16),
    ("self-74", 64, 20, 1, 75, 74, torch.bfloat16),
    ("self-t32", 4, 20, 32, 75, 0, torch.bfloat16),  # a 32-token prefill bucket
]


def _fq_calls(mode: str, x, w, b):
    """(kernel, plain) callables of one fused_quant mode."""
    if mode == "act":
        return lambda: fused_quant.act_quant(x), lambda: quantize_act(x)
    if mode == "ln":
        return (lambda: fused_quant.ln_quant(x, w, b),
                lambda: quantize_act(layer_norm(x, w, b)))
    impl = mode.split("-")[1]
    return lambda: fused_quant.gelu_quant(x, impl), lambda: quantize_act(gelu(x, impl))


def _fq_agreement(mode: str, got, want):
    """(within FQ_BOUNDS, scale max rel, max code levels apart, share of
    codes moved, dequant max_abs_err) of a fused_quant result vs plain."""
    (g8, gs), (r8, rs) = got, want
    rtol, max_levels, max_share = FQ_BOUNDS[mode.split("-")[0]]
    scale_rel = ((gs - rs).abs() / rs).max().item()
    diff = (g8.int() - r8.int()).abs()
    levels, moved = diff.max().item(), (diff > 0).sum().item()
    share = moved / diff.numel()
    err = (g8.float() * gs - r8.float() * rs).abs().max().item()
    ok = scale_rel <= rtol and levels <= max_levels and (moved == 0 or share < max_share)
    return ok, scale_rel, levels, share, err


def phase_int8_kernels(card: str) -> dict:
    """K2/K3 and K4 vs their plain versions; returns a row per case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for mode, n, d, dtype in FQ_CASES:
        x = (torch.randn(n, d, device="cuda", generator=gen) * 2).to(dtype)
        w, b = (torch.randn(d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        kern, plain = _fq_calls(mode, x, w, b)
        got = kern()
        torch.cuda.synchronize()
        ok, scale_rel, levels, share, err = _fq_agreement(mode, got, plain())
        ms, plain_ms, t = in_turns(plain, kern, 20)
        gbps = n * d * (x.element_size() + 1) / (ms * 1e-3) / 1e9
        bound = FQ_BOUNDS[mode.split("-")[0]]
        log(f"[int8-kernel] fused_quant {mode} ({n}, {d}) {str(dtype)[6:]}: scale max rel "
            f"{scale_rel:.3e}, codes max {levels} levels apart on {share:.3e} of them, "
            f"dequant max_abs_err {err:.3e} (bound: scale rtol {bound[0]:.1e}, {bound[1]} "
            f"level(s) on < {bound[2]:.0e}); kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
            f"plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}); kernel {gbps:.0f} GB/s "
            f"(read + write); {card}")
        if not ok:
            raise AssertionError(f"fused_quant {mode} disagrees with its plain version")
        if mode == "gelu-erf" and dtype == torch.bfloat16:
            # planted fault: the tanh kernel against the erf plain version
            # must fail the same bound
            passes, _, p_levels, p_share, _ = _fq_agreement(
                mode, fused_quant.gelu_quant(x, "tanh"), plain())
            log(f"[int8-kernel] planted fault, fused_quant gelu-tanh vs the erf plain version "
                f"({n}, {d}): codes max {p_levels} levels apart on {p_share:.3e} of them, "
                f"{'passes the bound: NOT caught' if passes else 'fails the bound: caught'}")
            if passes:
                raise AssertionError("the fused_quant bound does not tell a tanh GELU from erf")
        rows[mode if dtype == torch.bfloat16 else f"{mode}-f32"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del x, got
    for name, bsz, h, tq, c, n_past, dtype in K4_CASES:
        q = (torch.randn(bsz, h, tq, 64, device="cuda", generator=gen) * 0.3).to(dtype)
        if n_past is None:  # cross memory (B, H, D, C), contiguous
            k8, ks = quantize_kv(torch.randn(bsz, h, 64, c, device="cuda", generator=gen))
            v8, vs = quantize_kv(torch.randn(bsz, h, 64, c, device="cuda", generator=gen))
        else:  # layer 2 of a (B, L, H, D, C) cache, read in place
            kc, vc = (quantize_kv(torch.randn(bsz, 4, h, 64, c, device="cuda", generator=gen))
                      for _ in range(2))
            k8, ks, v8, vs = kc.data[:, 2], kc.scale[:, 2], vc.data[:, 2], vc.scale[:, 2]
        args = (q, k8, ks, v8, vs, n_past)
        out = cross_attention_int8(*args)
        torch.cuda.synchronize()
        ref = cross_attention_int8_reference(*args)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        atol, rtol = K4_TOL[dtype]
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        ms, plain_ms, t = in_turns(lambda: cross_attention_int8_reference(*args),
                                   lambda: cross_attention_int8(*args), 50)
        gbps = bsz * h * 2 * 64 * c / (ms * 1e-3) / 1e9
        log(f"[int8-kernel] cross_attention_int8 {name} q ({bsz}, {h}, {tq}, 64) "
            f"{str(dtype)[6:]} over {c} keys, n_past {n_past}: max_abs_err {err:.3e} "
            f"(atol {atol:.0e}, rtol {rtol:.1e}); kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
            f"plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}); kernel {gbps:.0f} GB/s of int8 "
            f"K/V; {card}")
        if not ok:
            raise AssertionError(f"cross_attention_int8 {name} disagrees with its plain version: "
                                 f"max_abs_err {err}")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    if fused_quant.act_quant.launches == 0 or cross_attention_int8.masked_launches == 0:
        raise AssertionError("the int8 kernels were not launched")
    torch.cuda.empty_cache()
    return rows


def _int8_logit_margin(models, encs, init, a: int, b: int, row: int) -> None:
    """Print logit[a] - logit[b] after the prefix ``init`` on each device."""
    for dev, m in models.items():
        toks = torch.tensor([init]).to(dev)
        cache = KVCache(*init_quant_cache(m.config, 1, dev, ctx=len(init)))
        ck, cv = (QuantKV(x.data[:, row:row + 1], x.scale[:, row:row + 1])
                  for x in (encs[dev].cross_k, encs[dev].cross_v))
        lg, _ = decode_step(m.decoder, toks, 0, cache, ck, cv)
        log(f"[int8-parity]   {dev}: logit[{a}] - logit[{b}] = "
            f"{(lg[0, -1, a] - lg[0, -1, b]).item():.3e}")


def phase_int8_parity(card: str) -> None:
    cfg, path = tiny_checkpoint()
    models = {}
    for dev in ("cpu", "cuda"):
        m = load_model(str(path), device=dev, dtype=torch.float32)
        models[dev] = m.with_params(prepare_serving_params(m.params))
    moved = [name for name, t in _leaves(models["cpu"].params)
             if not torch.equal(t, dict(_leaves(models["cuda"].params))[name].cpu())]
    log(f"[int8-parity] prepare_serving_params on cpu and cuda: "
        f"{len(moved)} of {len(_leaves(models['cpu'].params))} tensors differ {moved[:4]}")
    audio = synthetic_audio(SAMPLE_RATE * 30, seed=30)
    batch = 2
    with torch.inference_mode():
        mel = mel_window(log_mel_spectrogram(torch.from_numpy(audio), models["cpu"].filters,
                                             frame_count(len(audio))), 0, 2 * cfg.n_audio_ctx)
        mel = mel[None].expand(batch, -1, -1)
        encs, logits = {}, {}
        for dev, m in models.items():
            encs[dev] = encode(m.encoder, mel.to(dev), quantize_kv=True)
            cache = KVCache(*init_quant_cache(cfg, batch, dev, ctx=8))
            sot = torch.full((batch, 1), m.vocab.token_sot, device=dev)
            logits[dev], _ = decode_step(m.decoder, sot, 0, cache, encs[dev].cross_k,
                                         encs[dev].cross_v)
        for name in ("cross_k", "cross_v"):
            g, c = getattr(encs["cuda"], name), getattr(encs["cpu"], name)
            d = (g.data.cpu().int() - c.data.int()).abs()
            log(f"[int8-parity] {name} codes: {d.max().item()} levels apart at most, on "
                f"{(d > 0).float().mean().item():.3e} of them")
        err = (logits["cpu"] - logits["cuda"].cpu()).abs().max().item()
        log(f"[int8-parity] first-step logits: cpu vs cuda max_abs_err {err:.3e} "
            f"(tol {INT8_PARITY_ATOL:.0e})")
        if not err <= INT8_PARITY_ATOL:
            raise AssertionError(f"int8 first-step logits differ between cpu and cuda: {err}")

    n_tok = 48
    _zero_launches()
    toks = {dev: make_serving_step(m, batch, n_tok, "int8")(audio) for dev, m in models.items()}
    n = _read_launches()
    if min(n.values()) == 0:
        raise AssertionError(f"a kernel of the int8 path was not launched on the card: {n}")
    sot = models["cpu"].vocab.token_sot
    for i in range(batch):
        c = toks["cpu"][0][i, :int(toks["cpu"][1][i])].tolist()
        g = toks["cuda"][0][i, :int(toks["cuda"][1][i])].tolist()
        agree = sum(x == y for x, y in zip(c, g)) / max(min(len(c), len(g)), 1)
        log(f"[int8-parity] row {i}: {len(c)} tokens on cpu, {len(g)} on cuda, "
            f"agreement {agree:.3f}")
        if c != g:
            j = _first_divergence(c, g)
            log(f"[int8-parity] row {i} parts at step {j}: cpu {c[j:j + 3]}, cuda {g[j:j + 3]}")
            _int8_logit_margin(models, encs, [sot] + c[:j], (c[j:j + 1] or [0])[0],
                               (g[j:j + 1] or [0])[0], i)
        if agree < INT8_AGREEMENT:
            raise AssertionError(f"int8 tokens agree {agree:.3f} < {INT8_AGREEMENT} in row {i}")
    log(f"[int8-parity] int8 serving step on cpu (plain versions) and cuda (kernels): "
        f"launches on cuda {n}; {card}")


def _leaves(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += _leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def _zero_launches() -> None:
    flash_attention.launches = 0
    fused_quant.act_quant.launches = fused_quant.ln_quant.launches = 0
    fused_quant.gelu_quant.launches = 0
    cross_attention_int8.launches = cross_attention_int8.masked_launches = 0


def _read_launches() -> dict:
    return {"k1": flash_attention.launches, "act": fused_quant.act_quant.launches,
            "ln": fused_quant.ln_quant.launches, "gelu": fused_quant.gelu_quant.launches,
            "k4": cross_attention_int8.launches, "k4_self": cross_attention_int8.masked_launches}


def phase_int8_main_path(card: str, model) -> dict:
    """The int8 serving step at batch 64; returns the first run's launches."""
    cfg = model.config
    t0 = time.perf_counter()
    served = model.with_params(prepare_serving_params(model.params))
    torch.cuda.synchronize()
    log(f"[int8-main] prepare_serving_params on cuda: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (the bf16 model included)")
    batch, n_tok = 64, 64
    step = make_serving_step(served, batch, n_tok, "int8")
    audio = synthetic_audio(SAMPLE_RATE * 30, seed=100)
    L = cfg.n_audio_layer
    first = None
    for run in (1, 2):
        served.timers.totals.clear()
        served.timers.counts.clear()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        toks, lengths = step(audio)
        wall = time.perf_counter() - t0
        n = _read_launches()
        first = first or n
        peak = torch.cuda.max_memory_allocated()
        tm = served.timers.totals
        steps = n["k4"] // (2 * cfg.n_text_layer)
        log(f"[int8-main] run {run}: batch {batch} x 30 s, W8A8 encoder, int8 decoder weights, "
            f"fused QKV, int8 cross memory and self cache, greedy, timestamps, {n_tok} tokens: "
            f"mel {tm['mel'] * 1e3:.1f} ms, encode {tm['encode'] * 1e3:.1f} ms, decode "
            f"{tm['decode'] * 1e3:.1f} ms ({steps} decode steps), total {wall * 1e3:.1f} ms; "
            f"{int(lengths.sum())} tokens, {len({tuple(r) for r in toks.tolist()})} distinct "
            f"rows; peak {peak / 1e9:.2f} GB; launches {n}; {card}")
        expect = {"k1": L, "act": L + 1, "ln": 2 * L, "gelu": L}
        if any(n[k] != v for k, v in expect.items()):
            raise AssertionError(f"encoder launches {n}, expected {expect} per step")
        if not (1 <= steps <= n_tok and n["k4"] == steps * 2 * cfg.n_text_layer
                and n["k4_self"] == steps * cfg.n_text_layer):
            raise AssertionError(f"decode launched cross_attention_int8 {n['k4']} times "
                                 f"({n['k4_self']} self), not 2 x {cfg.n_text_layer} per step")
        if toks.shape != (batch, n_tok) or not ((lengths >= 0) & (lengths <= n_tok)).all():
            raise AssertionError(f"bad output: tokens {tuple(toks.shape)}, lengths {lengths}")
        if not ((toks >= 0) & (toks < cfg.n_vocab)).all():
            raise AssertionError("token out of the vocab")
    log(f"[int8-main] row 0: {toks[0, :12].tolist()}... length {int(lengths[0])}")
    return first


def main() -> None:
    card = phase_device()
    phase_build()
    k1 = phase_kernel(card)
    phase_parity(card)
    k1_launches, model = phase_main_path(card)
    rows = phase_int8_kernels(card)
    phase_int8_parity(card)
    n = phase_int8_main_path(card, model)
    src, tpu = "whisper_tpu_torch/csrc/", "whisper_tpu/kernels/"
    entries = [
        ("flash_attention", "flash_attention.cu", "flash_attention.py:141", k1_launches, k1),
        ("fused_quant.act_quant", "fused_quant.cu", "fused_quant.py:113", n["act"], rows["act"]),
        ("fused_quant.ln_quant", "fused_quant.cu", "fused_quant.py:113", n["ln"], rows["ln"]),
        ("fused_quant.gelu_quant", "fused_quant.cu", "fused_quant.py:113", n["gelu"],
         rows["gelu-erf"]),
        ("cross_attention_int8.cross", "cross_attention_int8.cu", "cross_attention_int8.py:109",
         n["k4"] - n["k4_self"], rows["cross"]),
        ("cross_attention_int8.self", "cross_attention_int8.cu", "cross_attention_int8.py:109",
         n["k4_self"], rows["self"]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + replaces,
         "launches": launches, **row}
        for name, source, replaces, launches, row in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
