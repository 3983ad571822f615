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
   8 and 64), at causal and ragged shapes and at the edges of the bf16
   kernel's tiles (one query, one key, fewer keys than a tile, causal with
   Tq != Tk), with CUDA-event times taken in turns (plain, kernel, kernel,
   plain), TFLOP/s and the share of the bound; at both main shapes also
   F.scaled_dot_product_attention's time.
4. parity: a small f32 checkpoint transcribed on the CPU (plain attention)
   and on the card (the kernel); encoder output, first-step logits and
   greedy tokens must agree.
5. main path: a synthetic large-v3 checkpoint (random weights from a seed),
   loaded in bf16 on the card, transcribes a batch of 8 30 s clips through
   load_model + BatchTranscriber.transcribe_batch, with timestamps; the
   decoder's self-attention runs cached_attention (K5) n_text_layer times
   per forward.
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
9. decode kernels: cached_attention (K5, bf16 and f32, at the greedy step,
   its prefill bucket and the host beam's shape), permute_rows_multi (K6, on
   the 160-row int8 cache's four leaves with repeated rows, and on a bf16
   K/V pair) and cow_copy_rows (K7, the int8 cache with 1, 8, 32 and 96
   forked rows from cow_assign) against their plain versions, timed in turns, with
   the time of one PyTorch library call for the same function beside them.
10. beam parity: phase 4's checkpoint, beam 3, both decode_full routes on
   the CPU (plain versions) and on the card (kernels); tokens must be
   identical across devices, and the device beam must equal the host beam.
11. int8 beam main path: phase 8's prepared model runs make_serving_step at
   batch 32 with beam 5 (160 decoder rows, group-shared cross memory),
   twice; per forward n_text_layer K4 cross launches over batch 32 with 5
   query rows, n_text_layer K4 self launches, and exactly one K7 per decode
   step. The first run wraps K4 and K7 to record the cross q shapes and the
   forked rows and is not timed; the second runs as served and is timed.
12. bf16 host beam: phase 5's model through BatchTranscriber with beam 5
   over 4 clips, twice in the same way: K5 at every forward, K6 at every
   step whose beam sources moved (counted in the first run).

13. train kernels: flash_sdpa (K1c: the K1 forward writing its row
   statistics, the fused backward kernel) forward and backward against
   autograd of the plain version at the training path's shapes (large-v3
   encoder at batch 2, f32 and bf16; its causal decoder over a 64-token
   bucket), and the backward kernel alone against the plain backward
   (flash_sdpa_backward) on the same (q, k, v, out, lse, g), and
   flash_attention's qk_int8 variant (K1b) against its plain version at the
   encoder's (160, 1500, 64), bf16 and f32, causal or not; timed in turns,
   with F.scaled_dot_product_attention's forward and backward beside K1c
   and its backward alone beside the backward kernel, and K1c's forward
   alone (K1's f32 kernel) beside the plain version and
   F.scaled_dot_product_attention at the encoder's (40, 1500, 64) f32. K1b
   is then driven once through its entry point, ops.sdpa(use_flash=True,
   qk_int8=True).
14. train parity: one train step of a small f32 model (random weights from
   a seed, d_head 64) on the CPU (plain versions) and on the card (the
   kernels): the loss and every gradient leaf must agree, and the card's
   step launches K1's f32 kernel and the backward kernel once per layer.
15. train main path: large-v3 in f32 with random weights drawn on the card,
   finetune over two synthetic 30 s pairs at batch 2 for 4 steps (lr 1e-4,
   warm-up 1): every loss finite, the last below the first, K1's f32 kernel
   and the backward kernel each launched 2 x 32 times per step (all through
   flash_sdpa: flash_attention raises when a gradient is asked of it), the
   bf16 kernel and the plain backward never; ms per step and peak memory.

The line before the last is the kernels JSON: every kernel with its
main-path launches, error against its plain version, kernel, plain and
library times, and its bound (bytes over 3.35 TB/s or operations over the
peak rate of their type, whichever is larger; under a causal mask only the
keys it lets through count; the split-TF32 kernels' f32 operations at the
smaller of 67 TFLOP/s of f32 and three TF32 products at 495 TFLOP/s). It
imports nothing of jax and nothing of the JAX package. TF32 is switched off for matmuls and cuDNN
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
import torch.nn.functional as F

from whisper_tpu_torch.config import PRESETS, SAMPLE_RATE, WhisperConfig
from whisper_tpu_torch.decoding.device_beam import cow_assign
from whisper_tpu_torch.decoding.sequence import BeamSearchDecoder
from whisper_tpu_torch.decoding.task import DecodingOptions, decode_full
from whisper_tpu_torch.frontend.mel import (frame_count, log_mel_spectrogram, mel_filter_bank,
                                            mel_window)
from whisper_tpu_torch.io.ggml import tensor_schema, write_ggml
from whisper_tpu_torch.kernels import beam_gather, build
from whisper_tpu_torch.kernels import fused_quant
from whisper_tpu_torch.kernels.cross_attention_int8 import (cross_attention_int8,
                                                            cross_attention_int8_reference)
from whisper_tpu_torch.kernels.decode_attention import (cached_attention,
                                                        cached_attention_reference, causal_mask)
from whisper_tpu_torch.kernels import flash_attention as flash_attention_module
from whisper_tpu_torch.kernels.flash_attention import (flash_attention, flash_attention_backward,
                                                       flash_attention_int8_reference,
                                                       flash_attention_lse,
                                                       flash_attention_reference, flash_sdpa,
                                                       flash_sdpa_backward)
from whisper_tpu_torch.kernels import ops
from whisper_tpu_torch.kernels.ops import gelu, layer_norm
from whisper_tpu_torch.model import decoder as decoder_module
from whisper_tpu_torch.model.decoder import KVCache, decode_step, init_cache
from whisper_tpu_torch.model.encoder import encode
from whisper_tpu_torch.model.load import load_model, random_model
from whisper_tpu_torch.model.quant import QuantKV, init_quant_cache, quantize_act, quantize_kv
from whisper_tpu_torch.parallel.serving import BatchTranscriber
from whisper_tpu_torch.training import finetune as finetune_module
from whisper_tpu_torch.training.train import (init_train_state, leaves, make_optimizer,
                                              make_train_step)
from whisper_tpu_torch.utils.benchmark import make_serving_step, prepare_serving_params

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "build" / "synthetic"

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
# f32 operations per element of fused_quant, for its bound: the quantizer
# (|x|, max, divide, round) 4; LN's moments, normalise and affine 8 more;
# the erf GELU (A-S polynomial, exp) ~16 more. Either way it is bound by bytes.
FQ_OPS = {"act": 4, "ln": 12, "gelu": 20}
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
# K5 vs _kvmajor_sdpa: K4's reasoning. Both take the same f32 logits and
# softmax and round the NORMALISED p to the cache's dtype (two passes, no
# online softmax), so only the order of the f32 sums differs: a bf16 output
# may move by one ulp (2^-7 of its magnitude), an f32 one by f32 noise.
K5_TOL = K4_TOL
# K1c's gradients against autograd of the plain version in f32 (on the
# upcast inputs for bf16): the backward recomputes the same f32 softmax, so
# only the order of the f32 sums differs (the CPU tests' bound, 2e-4 and
# 1e-3); a bf16 gradient is that f32 result rounded to bf16, within 2^-8 of
# its magnitude.
K1C_GRAD_TOL = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (2e-4, 2 ** -7)}
# K1b vs its plain version: the same codes and bit-identical f32 scores
# (an exact int32 dot, the same products in the same order), so only exp and
# the order of the f32 sums differ: f32 as K1; a bf16 output within one bf16
# ulp (2^-7 of its magnitude), as K4.
K1B_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}
# One train step, CPU vs card, f32 (TF32 off): GEMM, convolution and K1 sums
# in other orders; the loss and each gradient leaf relative to its largest
# element. The CPU tests hold the port to JAX at 1e-5 of the same measure.
TRAIN_PARITY_REL = 1e-4
KERNELS = ("flash_attention", "flash_attention_bwd", "fused_quant", "cross_attention_int8",
           "decode_attention", "beam_gather")
INT8_PATH = ("k1", "act", "ln", "gelu", "k4", "k4_self")  # the int8 greedy step's kernels
# The card's published peaks (NVIDIA's H100 SXM data sheet, dense rates):
# device memory rate, and operations per second by the type the kernel
# computes in (bf16 on the tensor cores, f32 on CUDA cores; TF32 for the
# split-TF32 kernels, see bound_ms).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_TF32 = 495e12


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


def bound_ms(n_bytes: float, n_ops: float, dtype, split_tf32: bool = False) -> tuple:
    """(the least time the card could take, in ms; "bytes" or "operations",
    whichever bounds it): each input read once and each output written once
    over the memory rate, against the operations over the peak of their
    type. ``n_ops`` may be a {dtype: operations} dict for work in several
    types. With ``split_tf32`` (K1's f32 kernel and the K1c backward, which
    run each f32 product as three TF32 products on the tensor cores) the f32
    operations take the smaller of two figures, f32 at 67 TFLOP/s and three
    TF32 products at 495 TFLOP/s, so that no row reads faster than its
    bound."""
    ops_by_type = n_ops if isinstance(n_ops, dict) else {dtype: n_ops}
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 0.0
    for t, n in ops_by_type.items():
        sec = n / PEAK_OPS[t]
        if split_tf32 and t == torch.float32:
            sec = min(sec, 3 * n / PEAK_TF32)
        t_ops += sec * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def causal_keys(n_past, tq: int, c: int) -> tuple:
    """(key positions any query sees, query-key pairs summed over the
    queries) under the mask key <= n_past + t; every key when n_past is None."""
    if n_past is None:
        return c, tq * c
    return min(c, n_past + tq), sum(min(c, n_past + t + 1) for t in range(tq))


def graph_ms(fn, iters: int) -> float:
    """CUDA-event time of one call captured in a CUDA graph and replayed:
    the device time of a small kernel without the wrapper's host cost."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


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
            if any(w in line for w in ("registers", "spill", "entry function", "wgmma")):
                log(f"[build]   {line.strip()}")


K1_CASES = [  # (batch, heads, tq, tk, causal, dtype)
    (8, 20, 1500, 1500, False, torch.bfloat16),  # encoder main path, large-v3 b8
    (64, 20, 1500, 1500, False, torch.bfloat16),  # int8 main path's encoder, b64
    (8, 20, 1500, 1500, False, torch.float32),
    (2, 20, 448, 448, True, torch.bfloat16),
    (2, 20, 448, 448, True, torch.float32),
    (2, 20, 100, 300, False, torch.bfloat16),
    (2, 20, 100, 300, False, torch.float32),
    # edges of the bf16 kernel's tiles: one query, one key, fewer keys than a
    # tile with a ragged query tile, causal with fewer and more queries than keys
    (2, 20, 1, 1500, False, torch.bfloat16),
    (2, 20, 1500, 1, False, torch.bfloat16),
    (2, 20, 200, 100, False, torch.bfloat16),
    (2, 20, 100, 300, True, torch.bfloat16),
    (2, 20, 300, 100, True, torch.bfloat16),
    (2, 20, 300, 100, True, torch.float32),
]


def phase_kernel(card: str) -> dict:
    """K1 vs its plain version; returns the bf16 rows of the two main paths'
    shapes, "b8" and "b64"."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}
    for b, h, tq, tk, causal, dtype in K1_CASES:
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
        # only the query-key pairs the causal mask lets through
        n_ops = 4 * b * h * causal_keys(0 if causal else None, tq, tk)[1] * 64
        bound, by = bound_ms(nbytes(q, k, v, out), n_ops, dtype, split_tf32=True)
        log(f"[kernel] flash_attention ({b * h}, {tq}x{tk}, 64) {str(dtype)[6:]} causal={causal}: "
            f"max_abs_err {err:.3e} (atol {atol:.0e}, rtol {rtol:.1e}); kernel {ms:.4f} ms "
            f"({t_k1:.4f}, {t_k2:.4f}), plain {plain_ms:.4f} ms ({t_plain1:.4f}, {t_plain2:.4f}); "
            f"kernel {n_ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, bound {bound:.4f} ms ({by}), "
            f"{bound / ms:.1%} of the bound; {card}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version: "
                                 f"max_abs_err {err}, atol {atol}, rtol {rtol}")
        if tq == tk == 1500 and b in (8, 64):  # TF32 off: the f32 library call is f32 too
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
            log(f"[kernel] flash_attention ({b * h}, {tq}x{tk}, 64) {str(dtype)[6:]}: kernel "
                f"{ms:.4f} ms, F.scaled_dot_product_attention {lib_ms:.4f} ms "
                f"({n_ops / (lib_ms * 1e-3) / 1e12:.1f} TFLOP/s), kernel / library "
                f"{ms / lib_ms:.2f}; bound {bound:.4f} ms ({by}); {card}")
            if dtype == torch.bfloat16:
                main[f"b{b}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
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

    launches0 = flash_attention.f32_launches
    results = {dev: bt.transcribe_batch(audios) for dev, bt in bts.items()}
    if flash_attention.f32_launches - launches0 != cfg.n_audio_layer:
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
    """Returns (the first run's launches, the bf16 large-v3 model)."""
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
        _zero_launches()
        t0 = time.perf_counter()
        results = bt.transcribe_batch(audios)
        wall = time.perf_counter() - t0
        n = _read_launches()
        n_launch, n_k5 = n["k1"], n["k5"]
        if run == 1:
            launches = n
        peak = torch.cuda.max_memory_allocated()
        tm = model.timers.totals
        n_tok = sum(len(r.tokens) for r in results)
        log(f"[main] run {run}: 8 x 30 s, bf16, greedy, timestamps, sample_len 64: "
            f"mel {tm['mel'] * 1e3:.1f} ms, encode {tm['encode'] * 1e3:.1f} ms, "
            f"decode {tm['decode'] * 1e3:.1f} ms, total {wall * 1e3:.1f} ms; "
            f"{n_tok} tokens; peak {peak / 1e9:.2f} GB; flash_attention launches {n_launch}, "
            f"cached_attention {n_k5} ({n_k5 // cfg.n_text_layer} forwards); {card}")
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
        if not (n_k5 and n_k5 % cfg.n_text_layer == 0 and n_k5 // cfg.n_text_layer <= 65):
            raise AssertionError(f"cached_attention launched {n_k5} times, not n_text_layer "
                                 f"({cfg.n_text_layer}) per forward over at most 65 forwards")
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
        # inputs read once (x, and LN's affine), int8 codes and f32 scales
        # written once; the f32 operations per element counted as FQ_OPS
        b_ms, by = bound_ms(nbytes(x, *((w, b) if mode == "ln" else ())) + n * d + 4 * n,
                            n * d * FQ_OPS[mode.split("-")[0]], torch.float32)
        rows[mode if dtype == torch.bfloat16 else f"{mode}-f32"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}
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
        c_eff, pairs = causal_keys(n_past, tq, c)
        gbps = bsz * h * 2 * 64 * c_eff / (ms * 1e-3) / 1e9
        log(f"[int8-kernel] cross_attention_int8 {name} q ({bsz}, {h}, {tq}, 64) "
            f"{str(dtype)[6:]} over {c} keys, n_past {n_past}: max_abs_err {err:.3e} "
            f"(atol {atol:.0e}, rtol {rtol:.1e}); kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
            f"plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}); kernel {gbps:.0f} GB/s of int8 "
            f"K/V; {card}")
        if not ok:
            raise AssertionError(f"cross_attention_int8 {name} disagrees with its plain version: "
                                 f"max_abs_err {err}")
        # only the keys the mask lets through: codes and scales of K and V
        b_ms, by = bound_ms(nbytes(q, out) + 2 * bsz * h * c_eff * (64 + 4),
                            4 * bsz * h * pairs * 64, dtype)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": by, "library_ms": None}
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
    n = {key: v for key, v in _read_launches().items() if key in INT8_PATH or key == "k1_f32"}
    del n["k1"]  # the f32 checkpoint's attention runs K1's f32 kernel, not the bf16 one
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
    flash_attention.launches = flash_attention.f32_launches = flash_attention.int8_launches = 0
    flash_sdpa.bwd_launches = 0
    fused_quant.act_quant.launches = fused_quant.ln_quant.launches = 0
    fused_quant.gelu_quant.launches = 0
    cross_attention_int8.launches = cross_attention_int8.masked_launches = 0
    cached_attention.launches = 0
    beam_gather.permute_rows_multi.launches = beam_gather.cow_copy_rows.launches = 0


def _read_launches() -> dict:
    return {"k1": flash_attention.launches, "k1_f32": flash_attention.f32_launches,
            "k1b": flash_attention.int8_launches, "k1c_bwd": flash_sdpa.bwd_launches,
            "act": fused_quant.act_quant.launches,
            "ln": fused_quant.ln_quant.launches, "gelu": fused_quant.gelu_quant.launches,
            "k4": cross_attention_int8.launches, "k4_self": cross_attention_int8.masked_launches,
            "k5": cached_attention.launches, "k6": beam_gather.permute_rows_multi.launches,
            "k7": beam_gather.cow_copy_rows.launches}


def phase_int8_main_path(card: str, model):
    """The int8 serving step at batch 64; returns (the first run's launches,
    the prepared model)."""
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
    return first, served


K5_CASES = [  # (name, batch, heads, tq, ctx, n_past, dtype): layer 2 of a (B, 4, H, 64, C) cache
    ("b8", 8, 20, 1, 104, 40, torch.bfloat16),          # phase 5's greedy step, large-v3 b8
    ("b8-prefill", 8, 20, 32, 104, 0, torch.bfloat16),  # its 32-token prefill bucket
    ("beam", 20, 20, 1, 448, 40, torch.bfloat16),       # phase 12's host beam, 4 x 5 rows
    ("b8-f32", 8, 20, 1, 104, 40, torch.float32),
    ("b8-prefill-f32", 8, 20, 32, 104, 0, torch.float32),
    ("beam-f32", 20, 20, 1, 448, 40, torch.float32),
]
BEAM_GROUPS, BEAM = 32, 5  # phase 11: 32 windows x 5 beams = 160 decoder rows


def _int8_beam_cache(gen, rows: int, ctx: int):
    """The four leaves of an int8 self cache of ``rows`` rows: K and V codes
    (rows, 32, 20, 64, ctx) and f32 scales (rows, 32, 20, ctx)."""
    leaves = []
    for _ in range(2):
        leaves.append(torch.randint(-127, 128, (rows, 32, 20, 64, ctx), dtype=torch.int8,
                                    device="cuda", generator=gen))
        leaves.append(torch.rand((rows, 32, 20, ctx), device="cuda", generator=gen))
    return leaves


def _k5_cases(card: str, gen, rows: dict) -> None:
    for name, bsz, h, tq, c, n_past, dtype in K5_CASES:
        q = (torch.randn(bsz, h, tq, 64, device="cuda", generator=gen) * 0.5).to(dtype)
        kc, vc = (torch.randn(bsz, 4, h, 64, c, device="cuda", generator=gen).to(dtype)
                  for _ in range(2))
        k, v = kc[:, 2], vc[:, 2]  # one layer, read in place
        args = (q, k, v, n_past)
        out = cached_attention(*args)
        torch.cuda.synchronize()
        ref = cached_attention_reference(*args)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        atol, rtol = K5_TOL[dtype]
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        ms, plain_ms, t = in_turns(lambda: cached_attention_reference(*args),
                                   lambda: cached_attention(*args), 50)
        mask = causal_mask(n_past, tq, c, "cuda")
        kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kt, vt, attn_mask=mask), 50)
        g_ms = graph_ms(lambda: cached_attention(*args), 50)
        # only the keys the mask lets through
        c_eff, pairs = causal_keys(n_past, tq, c)
        b_ms, by = bound_ms(nbytes(q, out) + 2 * bsz * h * 64 * c_eff * k.element_size(),
                            4 * bsz * h * pairs * 64, dtype)
        log(f"[decode-kernel] cached_attention {name} q ({bsz}, {h}, {tq}, 64) {str(dtype)[6:]} "
            f"over {c} positions, n_past {n_past}: max_abs_err {err:.3e} (atol {atol:.0e}, "
            f"rtol {rtol:.1e}); kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain "
            f"{plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), F.scaled_dot_product_attention "
            f"{lib_ms:.4f} ms; kernel in a CUDA graph {g_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({by}, {c_eff} of {c} positions seen); {card}")
        if not ok:
            raise AssertionError(f"cached_attention {name} disagrees with its plain version: "
                                 f"max_abs_err {err}")
        rows[f"k5-{name}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        del q, kc, vc, out, ref, diff


def _k6_cases(card: str, gen, rows: dict) -> None:
    n_rows = BEAM_GROUPS * BEAM
    cases = [("int8", _int8_beam_cache(gen, n_rows, 75),
              torch.randint(0, n_rows, (n_rows,), device="cuda", generator=gen)),
             ("bf16", [torch.randn((4 * BEAM, 32, 20, 64, 448), device="cuda",
                                   generator=gen).to(torch.bfloat16) for _ in range(2)],
              torch.randint(0, 4 * BEAM, (4 * BEAM,), device="cuda", generator=gen))]
    for name, leaves, idx in cases:
        if idx.unique().numel() == idx.numel():
            raise AssertionError("the K6 case needs repeated rows")
        got = beam_gather.permute_rows_multi(leaves, idx)
        torch.cuda.synchronize()
        want = beam_gather.permute_rows_reference(leaves, idx)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        ms, plain_ms, t = in_turns(lambda: beam_gather.permute_rows_reference(leaves, idx),
                                   lambda: beam_gather.permute_rows_multi(leaves, idx), 10)
        lib_ms = cuda_ms(lambda: [a.index_select(0, idx) for a in leaves], 10)
        # each distinct source row read once, every output row written once
        moved = nbytes(*got) * (1 + idx.unique().numel() / idx.numel()) + nbytes(idx)
        b_ms, by = bound_ms(moved, 0, torch.bfloat16)
        shapes = " + ".join(f"{tuple(a.shape)} {str(a.dtype)[6:]}" for a in leaves)
        log(f"[decode-kernel] permute_rows_multi {name}: {shapes}, {idx.unique().numel()} "
            f"distinct of {idx.numel()} rows: {'bit-exact' if same else 'DIFFERS'}; kernel "
            f"{ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain {plain_ms:.4f} ms ({t[0]:.4f}, "
            f"{t[3]:.4f}), index_select per leaf {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({by}, "
            f"{moved / 1e9:.3f} GB); kernel {moved / (ms * 1e-3) / 1e9:.0f} GB/s; {card}")
        if not same:
            raise AssertionError(f"permute_rows_multi {name} differs from index_select")
        rows[f"k6-{name}"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        del leaves, got, want
    torch.cuda.empty_cache()


def _fork_src(n_forks: int) -> torch.Tensor:
    """copy_src of cow_assign over 32 groups of 5 beams with ``n_forks``
    forked rows spread over the groups: a group with f forks takes beam 0
    f + 1 times and drops its last f beams."""
    rows = []
    for g in range(BEAM_GROUPS):
        f = n_forks // BEAM_GROUPS + (g < n_forks % BEAM_GROUPS)
        rows.append([0] * (f + 1) + list(range(1, BEAM - f)))
    new_src = torch.tensor(rows, device="cuda")
    phys = torch.arange(BEAM, device="cuda").repeat(BEAM_GROUPS, 1)
    _, copy_src = cow_assign(phys, new_src, BEAM)
    return (copy_src + torch.arange(BEAM_GROUPS, device="cuda")[:, None] * BEAM).reshape(-1)


def _k7_cases(card: str, gen, rows: dict) -> None:
    leaves = _int8_beam_cache(gen, BEAM_GROUPS * BEAM, 75)
    row_bytes = sum(a[0].numel() * a.element_size() for a in leaves)
    for n_forks in (1, 8, 32, 96):  # 96: phase 11's reading, ~96.5 forked rows a step
        src = _fork_src(n_forks)
        ar = torch.arange(src.numel(), device="cuda")
        if int((src != ar).sum()) != n_forks:
            raise AssertionError(f"cow_assign forked {int((src != ar).sum())} rows, "
                                 f"expected {n_forks}")
        before = [a.clone() for a in leaves]
        want = beam_gather.cow_copy_rows_reference([a.clone() for a in leaves], src)
        beam_gather.cow_copy_rows(leaves, src)
        torch.cuda.synchronize()
        same = all(torch.equal(a, w) for a, w in zip(leaves, want))
        ident = src == ar
        untouched = all(torch.equal(a[ident], b[ident]) for a, b in zip(leaves, before))
        dst = ar[~ident]
        srcs = src[dst]
        ms, plain_ms, t = in_turns(lambda: beam_gather.cow_copy_rows_reference(leaves, src),
                                   lambda: beam_gather.cow_copy_rows(leaves, src), 20)
        lib_ms = cuda_ms(lambda: [a.index_copy_(0, dst, a.index_select(0, srcs))
                                  for a in leaves], 20)
        g_ms = graph_ms(lambda: beam_gather.cow_copy_rows(leaves, src), 20)
        # each forked row written once, each distinct source row read once
        moved = (n_forks + srcs.unique().numel()) * row_bytes + nbytes(src)
        b_ms, by = bound_ms(moved, 0, torch.bfloat16)
        log(f"[decode-kernel] cow_copy_rows int8 cache (160 rows, 4 leaves, {row_bytes / 1e6:.2f} "
            f"MB a row), {n_forks} forked rows: {'bit-exact' if same else 'DIFFERS'}, identity "
            f"rows {'untouched' if untouched else 'CHANGED'}; kernel {ms:.4f} ms ({t[1]:.4f}, "
            f"{t[2]:.4f}), plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), index_copy_ per "
            f"leaf {lib_ms:.4f} ms; kernel in a CUDA graph {g_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({by}); {card}")
        if not (same and untouched):
            raise AssertionError(f"cow_copy_rows with {n_forks} forks differs from its plain "
                                 f"version or touched an identity row")
        rows[f"k7-{n_forks}"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        del before, want
    del leaves
    torch.cuda.empty_cache()


def phase_decode_kernels(card: str) -> dict:
    """K5, K6 and K7 against their plain versions; returns a row per case."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    _k5_cases(card, gen, rows)
    _k6_cases(card, gen, rows)
    _k7_cases(card, gen, rows)
    return rows


def phase_beam_parity(card: str) -> None:
    """Beam 3 on phase 4's f32 checkpoint, both routes, CPU vs card."""
    cfg, path = tiny_checkpoint()
    models = {dev: load_model(str(path), device=dev, dtype=torch.float32)
              for dev in ("cpu", "cuda")}
    audios = [synthetic_audio(SAMPLE_RATE * s, seed=s) for s in (7, 30)]
    options = DecodingOptions(beam_size=3, sample_len=32, without_timestamps=False)
    tokens = {}
    with torch.inference_mode():
        mel = BatchTranscriber(models["cpu"], 2)._mel_batch(audios)
        for dev, m in models.items():
            enc = m.encoder(mel.to(dev))
            _zero_launches()
            for route in ("host", "device"):
                res = decode_full(m.decoder, m.vocab, enc.cross_k, enc.cross_v, options,
                                  use_device_loop=route == "device")
                tokens[dev, route] = [r.tokens for r in res]
            n = _read_launches()
    for route in ("host", "device"):
        for i, (c, g) in enumerate(zip(tokens["cpu", route], tokens["cuda", route])):
            log(f"[beam-parity] {route} beam, stream {i}: {len(c)} tokens on cpu, {len(g)} on "
                f"cuda, {'identical' if c == g else 'parting at ' + str(_first_divergence(c, g))}")
            if c != g:
                raise AssertionError(f"{route} beam tokens differ between cpu and cuda")
    if tokens["cuda", "device"] != tokens["cuda", "host"]:
        raise AssertionError("on the card the device beam differs from the host beam")
    if min(n["k5"], n["k6"], n["k7"]) == 0:
        raise AssertionError(f"a decode kernel was not launched on the card: {n}")
    log(f"[beam-parity] beam 3, timestamps: tokens identical on cpu and cuda for both routes, "
        f"and the device beam equals the host beam; launches on cuda {n}; {card}")


def phase_int8_beam_main_path(card: str, served) -> dict:
    """make_serving_step at batch 32, beam 5, int8, twice: the first run
    instrumented and not timed, the second as served and timed. Returns the
    second run's launches."""
    cfg = served.config
    L = cfg.n_text_layer
    step = make_serving_step(served, BEAM_GROUPS, 64, "int8", beam_size=BEAM)
    audio = synthetic_audio(SAMPLE_RATE * 30, seed=100)
    # The first run wraps the decoder's K4 name to record the cross calls' q
    # shapes, and the device beam's K7 name to sum the forked rows on the
    # device; both hand on to the real wrappers.
    from whisper_tpu_torch.decoding import device_beam
    real_k4, real_k7 = decoder_module.cross_attention_int8, device_beam.cow_copy_rows
    cross_shapes, forks = set(), torch.zeros((), dtype=torch.long, device="cuda")

    def k4_spy(q, *args, n_past=None):
        if n_past is None:
            cross_shapes.add(tuple(q.shape))
        return real_k4(q, *args, n_past=n_past)

    def k7_spy(leaves, src):
        forks.add_((src != torch.arange(src.numel(), device=src.device)).sum())
        return real_k7(leaves, src)

    for run in (1, 2):
        instrumented = run == 1
        served.timers.totals.clear()
        served.timers.counts.clear()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        if instrumented:
            decoder_module.cross_attention_int8, device_beam.cow_copy_rows = k4_spy, k7_spy
        try:
            t0 = time.perf_counter()
            fin_toks, fin_count = step(audio)
            wall = time.perf_counter() - t0
        finally:
            decoder_module.cross_attention_int8, device_beam.cow_copy_rows = real_k4, real_k7
        n = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        tm = served.timers.totals
        forwards = n["k4_self"] // L
        head = (f"[int8-beam] run {run}: {BEAM_GROUPS} windows x {BEAM} beams (160 rows) x 30 s, "
                f"int8 as phase 8, 64 tokens, {forwards} forwards, {n['k7']} decode steps")
        if instrumented:
            log(f"{head}, instrumented (times not kept): forked rows {int(forks)} "
                f"({int(forks) / max(n['k7'], 1):.2f} a step); cross q shapes "
                f"{sorted(cross_shapes)}; launches {n}")
            if {(s[0], s[2]) for s in cross_shapes} != {(BEAM_GROUPS, 3 * BEAM),
                                                        (BEAM_GROUPS, BEAM)}:
                raise AssertionError(f"cross-attention q shapes {cross_shapes}: the cross "
                                     f"memory is not read once per group")
        else:
            log(f"{head}, as served: mel {tm['mel'] * 1e3:.1f} ms, encode "
                f"{tm['encode'] * 1e3:.1f} ms, decode {tm['decode'] * 1e3:.1f} ms, total "
                f"{wall * 1e3:.1f} ms; fin_count {fin_count.tolist()[:8]}...; peak "
                f"{peak / 1e9:.2f} GB; launches {n}; {card}")
        if not (forwards >= 2 and n["k4_self"] == forwards * L
                and n["k4"] - n["k4_self"] == forwards * L):
            raise AssertionError(f"K4 launched {n['k4']} times ({n['k4_self']} self), not "
                                 f"n_text_layer cross + n_text_layer self per forward")
        if n["k7"] != forwards - 1:
            raise AssertionError(f"cow_copy_rows launched {n['k7']} times over {forwards - 1} "
                                 f"decode steps, not once a step")
        if fin_toks.shape != (BEAM_GROUPS, BEAM, 64) or not (
                (fin_count >= 0) & (fin_count <= BEAM)).all():
            raise AssertionError(f"bad output {tuple(fin_toks.shape)}, {fin_count}")
        if not ((fin_toks >= 0) & (fin_toks < cfg.n_vocab)).all():
            raise AssertionError("token out of the vocab")
    return n


def phase_host_beam(card: str, model) -> dict:
    """BatchTranscriber with beam 5 over 4 clips, bf16, twice: the first run
    instrumented and not timed, the second as served and timed. Returns the
    second run's launches."""
    cfg = model.config
    L = cfg.n_text_layer
    audios = [synthetic_audio(SAMPLE_RATE * 30, seed=200 + i) for i in range(4)]
    bt = BatchTranscriber(model, 4, options=DecodingOptions(beam_size=BEAM, sample_len=32))
    # The first run counts the steps whose beam sources moved, from the beam
    # decoder's own output: the host loop must reorder the cache (one K6) at
    # each of them.
    real_update, moved = BeamSearchDecoder.update, [0]

    def update_spy(self, tokens, logits, sum_logprobs):
        out = real_update(self, tokens, logits, sum_logprobs)
        moved[0] += not np.array_equal(out[2], np.arange(len(out[2])))
        return out

    for run in (1, 2):
        instrumented = run == 1
        model.timers.totals.clear()
        model.timers.counts.clear()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        if instrumented:
            BeamSearchDecoder.update = update_spy
        try:
            t0 = time.perf_counter()
            results = bt.transcribe_batch(audios)
            wall = time.perf_counter() - t0
        finally:
            BeamSearchDecoder.update = real_update
        n = _read_launches()
        tm = model.timers.totals
        head = (f"[host-beam] run {run}: 4 x 30 s, bf16, beam 5 (20 rows), timestamps, "
                f"sample_len 32, {n['k5'] // L} forwards, {n['k6']} reorders")
        if instrumented:
            log(f"{head}, instrumented (times not kept): {moved[0]} steps whose beam sources "
                f"moved; launches {n}")
            if n["k6"] != moved[0] or moved[0] == 0:
                raise AssertionError(f"permute_rows_multi launched {n['k6']} times for "
                                     f"{moved[0]} steps whose beam sources moved")
        else:
            log(f"{head}, as served: mel {tm['mel'] * 1e3:.1f} ms, encode "
                f"{tm['encode'] * 1e3:.1f} ms, decode {tm['decode'] * 1e3:.1f} ms, total "
                f"{wall * 1e3:.1f} ms; {sum(len(r.tokens) for r in results)} tokens; peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {n}; {card}")
            if n["k6"] == 0:
                raise AssertionError("permute_rows_multi was not launched")
        if n["k1"] != cfg.n_audio_layer or not (n["k5"] and n["k5"] % L == 0):
            raise AssertionError(f"launches {n}: K1 not once per encoder layer or K5 not "
                                 f"n_text_layer per forward")
        for r in results:
            if not all(0 <= t < cfg.n_vocab for t in r.tokens) or not math.isfinite(
                    r.avg_logprob):
                raise AssertionError(f"bad result {r}")
    log(f"[host-beam] stream 0: {results[0].tokens[:12]}... avg_logprob "
        f"{results[0].avg_logprob:.4f}")
    return n


K1C_CASES = [  # (batch·heads, tq, tk, causal, dtype): the training path at batch 2
    (2 * 20, 1500, 1500, False, torch.float32),   # large-v3 encoder self-attention, f32
    (2 * 20, 63, 63, True, torch.float32),        # its decoder over a 64-token bucket
    (2 * 20, 1500, 1500, False, torch.bfloat16),
]
K1B_CASES = [(160, 1500, False, torch.bfloat16), (160, 1500, True, torch.bfloat16),
             (160, 1500, False, torch.float32), (160, 1500, True, torch.float32)]


def _within(got, want, tol) -> tuple:
    """(every element within atol + rtol·|want|, max abs error)."""
    diff = (got.float() - want.float()).abs()
    atol, rtol = tol
    return bool((diff <= atol + rtol * want.float().abs()).all()), diff.max().item()


def _k1c_cases(card: str, gen, rows: dict) -> None:
    for bh, tq, tk, causal, dtype in K1C_CASES:
        q, k, v = (torch.randn(bh, t, 64, device="cuda", generator=gen).to(dtype).requires_grad_()
                   for t in (tq, tk, tk))
        g = torch.randn(bh, tq, 64, device="cuda", generator=gen).to(dtype)
        out = flash_sdpa(q, k, v, causal)
        grads = torch.autograd.grad(out, (q, k, v), g)
        torch.cuda.synchronize()
        # the plain version: autograd of flash_attention_reference in f32
        q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
        ref_grads = torch.autograd.grad(flash_attention_reference(q32, k32, v32, causal),
                                        (q32, k32, v32), g.float())
        ok, err = _within(out, flash_attention_reference(q, k, v, causal), K1_TOL[dtype])
        grad_err = 0.0
        for name, got, want in zip("qkv", grads, ref_grads):
            g_ok, g_err = _within(got, want, K1C_GRAD_TOL[dtype])
            ok, grad_err = ok and g_ok, max(grad_err, g_err)
        # the backward kernel alone against the plain backward, on the same
        # (q, k, v, out, lse, g) from the kernel forward
        qd, kd, vd = (t.detach() for t in (q, k, v))
        fwd_out, lse = flash_attention_lse(qd, kd, vd, causal)
        bwd = flash_attention_backward(qd, kd, vd, fwd_out, lse, g, causal)
        torch.cuda.synchronize()
        plain_bwd = flash_sdpa_backward(qd, kd, vd, fwd_out, lse, g, causal)
        bwd_err = 0.0
        for got, want in zip(bwd, plain_bwd):
            b_ok, b_err = _within(got, want, K1C_GRAD_TOL[dtype])
            ok, bwd_err = ok and b_ok, max(bwd_err, b_err)
        del plain_bwd
        iters = 5 if tq * tk > 1e6 else 50

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(q, k, v), (q, k, v), g)

        ms, plain_ms, t = in_turns(
            fwd_bwd(lambda q, k, v: flash_attention_reference(q, k, v, causal)),
            fwd_bwd(lambda q, k, v: flash_sdpa(q, k, v, causal)), iters)
        lib_ms = cuda_ms(fwd_bwd(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)), iters)
        bwd_ms, plain_bwd_ms, tb = in_turns(
            lambda: flash_sdpa_backward(qd, kd, vd, fwd_out, lse, g, causal),
            lambda: flash_attention_backward(qd, kd, vd, fwd_out, lse, g, causal), iters)
        # the library's backward alone: autograd of one F.scaled_dot_product_attention output
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (q, k, v), g,
                                                         retain_graph=True), iters)
        del lib_out
        # forward 4 and backward 10 operations per query-key pair and d (the
        # backward recomputes the scores, then dv, dp, dk and dq), the backward
        # in f32; q, k, v and g read once, out, dq, dk and dv written once
        # (the backward alone also reads out and lse)
        pairs = causal_keys(0 if causal else None, tq, tk)[1]
        n_ops = {dtype: 4 * bh * pairs * 64}
        n_ops[torch.float32] = n_ops.get(torch.float32, 0) + 10 * bh * pairs * 64
        b_ms, by = bound_ms(nbytes(q, k, v, g, out, *grads), n_ops, dtype, split_tf32=True)
        bwd_b_ms, bwd_by = bound_ms(nbytes(q, k, v, g, out, lse, *grads),
                                    10 * bh * pairs * 64, torch.float32, split_tf32=True)
        name = f"({bh}, {tq}x{tk}, 64) {str(dtype)[6:]} causal={causal}"
        log(f"[train-kernel] flash_sdpa {name}, forward and backward: output max_abs_err "
            f"{err:.3e} (atol {K1_TOL[dtype][0]:.0e}, rtol {K1_TOL[dtype][1]:.1e}), gradients "
            f"max_abs_err {grad_err:.3e} (atol {K1C_GRAD_TOL[dtype][0]:.0e}, rtol "
            f"{K1C_GRAD_TOL[dtype][1]:.1e}); kernel route {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
            f"plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), F.scaled_dot_product_attention "
            f"forward and backward {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({by}); {card}")
        log(f"[train-kernel] flash_attention_backward {name}: against flash_sdpa_backward on the "
            f"same (q, k, v, out, lse, g) max_abs_err {bwd_err:.3e} (K1C_GRAD_TOL); kernel "
            f"{bwd_ms:.4f} ms ({tb[1]:.4f}, {tb[2]:.4f}), plain {plain_bwd_ms:.4f} ms "
            f"({tb[0]:.4f}, {tb[3]:.4f}), F.scaled_dot_product_attention backward {lib_bwd_ms:.4f} ms; bound "
            f"{bwd_b_ms:.4f} ms ({bwd_by}); {card}")
        if not ok:
            raise AssertionError(f"flash_sdpa {name} disagrees with autograd of its plain "
                                 f"version, or its backward kernel with the plain backward")
        tag = f"{tq}-{str(dtype)[6:]}"
        rows[f"k1c-{tag}"] = {
            "max_abs_err": max(err, grad_err), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib_ms}
        rows[f"k1c-bwd-{tag}"] = {
            "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_b_ms,
            "bound_by": bwd_by, "library_ms": lib_bwd_ms}
        del q, k, v, g, out, grads, ref_grads, q32, k32, v32, qd, kd, vd, fwd_out, lse, bwd
        torch.cuda.empty_cache()


def _k1_f32_case(card: str, gen, rows: dict) -> None:
    """K1c's forward alone, K1's f32 kernel, at the training path's encoder
    shape (large-v3 at batch 2): the kernel the train step launches."""
    q, k, v = (torch.randn(2 * 20, 1500, 64, device="cuda", generator=gen) for _ in range(3))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ok, err = _within(out, flash_attention_reference(q, k, v), K1_TOL[torch.float32])
    ms, plain_ms, t = in_turns(lambda: flash_attention_reference(q, k, v),
                               lambda: flash_attention(q, k, v), 10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)  # TF32 off
    n_ops = 4 * q.shape[0] * 1500 * 1500 * 64
    b_ms, by = bound_ms(nbytes(q, k, v, out), n_ops, torch.float32, split_tf32=True)
    log(f"[train-kernel] flash_attention f32 forward (40, 1500x1500, 64): max_abs_err "
        f"{err:.3e} (atol {K1_TOL[torch.float32][0]:.0e}, rtol {K1_TOL[torch.float32][1]:.1e}); "
        f"kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), {n_ops / (ms * 1e-3) / 1e12:.1f} "
        f"TFLOP/s, plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), "
        f"F.scaled_dot_product_attention {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({by}); {card}")
    if not ok:
        raise AssertionError(f"flash_attention f32 (40, 1500) disagrees with its plain "
                             f"version: max_abs_err {err}")
    rows["k1-f32"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": by, "library_ms": lib_ms}


def _k1b_cases(card: str, gen, rows: dict) -> None:
    for bh, t, causal, dtype in K1B_CASES:
        q, k, v = (torch.randn(bh, t, 64, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        out = flash_attention(q, k, v, causal=causal, qk_int8=True)
        torch.cuda.synchronize()
        ok, err = _within(out, flash_attention_int8_reference(q, k, v, causal), K1B_TOL[dtype])
        ms, plain_ms, tt = in_turns(
            lambda: flash_attention_int8_reference(q, k, v, causal),
            lambda: flash_attention(q, k, v, causal=causal, qk_int8=True), 10)
        # the int8 score dot and the PV product in v's type, over the pairs
        # the mask lets through
        pairs = causal_keys(0 if causal else None, t, t)[1]
        b_ms, by = bound_ms(nbytes(q, k, v, out),
                            {torch.int8: 2 * bh * pairs * 64, dtype: 2 * bh * pairs * 64}, dtype)
        log(f"[train-kernel] flash_attention qk_int8 ({bh}, {t}x{t}, 64) {str(dtype)[6:]} "
            f"causal={causal}: max_abs_err {err:.3e} (atol {K1B_TOL[dtype][0]:.0e}, rtol "
            f"{K1B_TOL[dtype][1]:.1e}); kernel {ms:.4f} ms ({tt[1]:.4f}, {tt[2]:.4f}), plain "
            f"{plain_ms:.4f} ms ({tt[0]:.4f}, {tt[3]:.4f}); bound {b_ms:.4f} ms ({by}); {card}")
        if not ok:
            raise AssertionError(f"flash_attention qk_int8 ({bh}, {t}) {dtype} causal={causal} "
                                 f"disagrees with its plain version: max_abs_err {err}")
        rows[f"k1b-{str(dtype)[6:]}-{'causal' if causal else 'full'}"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}
        del q, k, v, out
    torch.cuda.empty_cache()


def phase_train_kernels(card: str) -> tuple:
    """K1c and K1b against their plain versions; returns (a row per case,
    the launches of K1b's entry-point run)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    _k1c_cases(card, gen, rows)
    _k1_f32_case(card, gen, rows)
    _k1b_cases(card, gen, rows)
    q, k, v = (torch.randn(8, 20, 1500, 64, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    _zero_launches()
    out = ops.sdpa(q, k, v, use_flash=True, qk_int8=True)
    entry = _read_launches()
    torch.cuda.synchronize()
    if (entry["k1b"] != 1 or entry["k1"] or entry["k1_f32"]
            or not torch.isfinite(out.float()).all()):
        raise AssertionError(f"ops.sdpa(use_flash=True, qk_int8=True) launches {entry}")
    log(f"[train-kernel] ops.sdpa(use_flash=True, qk_int8=True) on (8, 20, 1500, 64) bf16: "
        f"launches {entry}")
    return rows, entry


def _train_config() -> WhisperConfig:
    """The parity phases' small model (d_head 64), English-only."""
    return dataclasses.replace(PRESETS["tiny.en"], n_audio_state=128, n_audio_head=2,
                               n_audio_layer=2, n_text_state=128, n_text_head=2,
                               n_text_layer=2, f16=0)


def train_pairs(n: int, seed: int):
    """n synthetic 30 s clips, each with a transcript of the random model's
    own token strings (``tok<id>``: 40 tokens, a 64-token bucket)."""
    rng = np.random.default_rng(seed)
    return [(synthetic_audio(SAMPLE_RATE * 30, seed=seed + i),
             "".join(f"tok{t}" for t in rng.integers(1000, 40000, 40))) for i in range(n)]


def phase_train_parity(card: str) -> None:
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the f32 parity of a train step")
    cfg = _train_config()
    models = {dev: random_model(cfg, seed=11, device=dev, on_device=False)
              for dev in ("cpu", "cuda")}
    batch = next(finetune_module.make_batches(models["cpu"], train_pairs(2, 40), 2))
    optimizer = make_optimizer(1e-3)
    losses, grads = {}, {}
    _zero_launches()
    for dev, m in models.items():
        state = init_train_state(m.params, optimizer)
        state, loss = make_train_step(cfg, optimizer)(state, *(t.to(dev) for t in batch))
        losses[dev] = loss.item()
        grads[dev] = [p.grad.cpu() for p in leaves(state.params)]
    n = _read_launches()
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    grad_rel = max(((gc - gg).abs().max() / gc.abs().max().clamp_min(1e-30)).item()
                   for gc, gg in zip(grads["cpu"], grads["cuda"]))
    log(f"[train-parity] one f32 train step (d128, 2 + 2 layers, batch 2, T "
        f"{batch[1].shape[1]}), TF32 off for matmul and cuDNN: loss cpu {losses['cpu']:.6f} "
        f"cuda {losses['cuda']:.6f}, max rel diff {loss_rel:.3e}; gradients over "
        f"{len(grads['cpu'])} leaves, max rel diff {grad_rel:.3e} (tol {TRAIN_PARITY_REL:.0e}); "
        f"launches on cuda {n}; {card}")
    if not (loss_rel <= TRAIN_PARITY_REL and grad_rel <= TRAIN_PARITY_REL):
        raise AssertionError("a train step differs between cpu and cuda")
    per_forward = cfg.n_audio_layer + cfg.n_text_layer
    if n["k1_f32"] != per_forward or n["k1c_bwd"] != per_forward or n["k1"]:
        raise AssertionError(f"the cuda train step did not run K1's f32 kernel and the K1c "
                             f"backward kernel once per attention layer: {n}")


def phase_train(card: str) -> dict:
    """finetune of large-v3 in f32 for 4 steps; returns its launches."""
    cfg = PRESETS["large-v3"]
    t0 = time.perf_counter()
    model = random_model(cfg, seed=0, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    log(f"[train] random large-v3 f32 drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    pairs = train_pairs(2, 300)
    # The step is wrapped to read each step's loss, wall time and launches;
    # it hands on to the real one. The plain backward is wrapped to count its
    # calls: on the card it must run on no path.
    steps, real = [], finetune_module.make_train_step
    real_plain_bwd, plain_bwd_calls = flash_attention_module.flash_sdpa_backward, []

    def plain_bwd_spy(*args, **kwargs):
        plain_bwd_calls.append(args[0].device)
        return real_plain_bwd(*args, **kwargs)

    def timed(cfg_, optimizer):
        step_fn = real(cfg_, optimizer)

        def run(state, *batch):
            before = _read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step_fn(state, *batch)
            loss = loss.item()  # waits for the step
            n = _read_launches()
            steps.append((loss, time.perf_counter() - t0, n["k1_f32"] - before["k1_f32"],
                          n["k1"] - before["k1"], n["k1c_bwd"] - before["k1c_bwd"],
                          batch[1].shape[1]))
            return state, loss
        return run

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    finetune_module.make_train_step = timed
    flash_attention_module.flash_sdpa_backward = plain_bwd_spy
    try:
        t0 = time.perf_counter()
        state = finetune_module.finetune(model, pairs, steps=4, batch_size=2, lr=1e-4, warmup=1,
                                         log_every=100)
        wall = time.perf_counter() - t0
    finally:
        finetune_module.make_train_step = real
        flash_attention_module.flash_sdpa_backward = real_plain_bwd
    n = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in leaves(state.params))
    for i, (loss, sec, k1_f32, k1_bf16, k1c_bwd, T) in enumerate(steps, 1):
        log(f"[train] step {i}: loss {loss:.6f}, {sec * 1e3:.1f} ms, K1 f32 launches {k1_f32} "
            f"(bf16 {k1_bf16}), K1c backward launches {k1c_bwd}, tokens (2, {T})")
    log(f"[train] large-v3 f32, batch 2 x 30 s, 4 steps, lr 1e-4, warm-up 1: {wall:.2f} s in "
        f"finetune (batches and mel included), steps {[round(x[1] * 1e3, 1) for x in steps]} ms, "
        f"{n_params / 1e9:.3f} B params; peak {peak / 1e9:.2f} GB; launches {n}; plain "
        f"backward calls {len(plain_bwd_calls)}; {card}")
    losses = [x[0] for x in steps]
    per_forward = cfg.n_audio_layer + cfg.n_text_layer
    if len(steps) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if any(k1_f32 != per_forward or k1_bf16 or k1c_bwd != per_forward
           for _, _, k1_f32, k1_bf16, k1c_bwd, _ in steps):
        raise AssertionError(f"K1's f32 kernel and the K1c backward kernel not launched "
                             f"{per_forward} times per step: {steps}")
    if plain_bwd_calls:
        raise AssertionError(f"the plain backward ran {len(plain_bwd_calls)} times on the card")
    del model, state
    torch.cuda.empty_cache()
    return n


def main() -> None:
    card = phase_device()
    phase_build()
    k1 = phase_kernel(card)
    phase_parity(card)
    bf16, model = phase_main_path(card)
    rows = phase_int8_kernels(card)
    phase_int8_parity(card)
    n, served = phase_int8_main_path(card, model)
    rows.update(phase_decode_kernels(card))
    phase_beam_parity(card)
    beam = phase_int8_beam_main_path(card, served)
    host = phase_host_beam(card, model)
    del model, served
    torch.cuda.empty_cache()
    train_rows, k1b_entry = phase_train_kernels(card)
    phase_train_parity(card)
    train = phase_train(card)
    src, tpu = "whisper_tpu_torch/csrc/", "whisper_tpu/kernels/"
    entries = [
        # K1's bf16 kernel on both encode paths (phases 5 and 8), with the b8
        # row; the b64 row beside it with phase 8's launches
        ("flash_attention", "flash_attention.cu", "flash_attention.py:141",
         bf16["k1"] + n["k1"], k1["b8"]),
        ("flash_attention.b64", "flash_attention.cu", "flash_attention.py:141", n["k1"],
         k1["b64"]),
        ("fused_quant.act_quant", "fused_quant.cu", "fused_quant.py:113", n["act"], rows["act"]),
        ("fused_quant.ln_quant", "fused_quant.cu", "fused_quant.py:113", n["ln"], rows["ln"]),
        ("fused_quant.gelu_quant", "fused_quant.cu", "fused_quant.py:113", n["gelu"],
         rows["gelu-erf"]),
        ("cross_attention_int8.cross", "cross_attention_int8.cu", "cross_attention_int8.py:109",
         n["k4"] - n["k4_self"], rows["cross"]),
        ("cross_attention_int8.self", "cross_attention_int8.cu", "cross_attention_int8.py:109",
         n["k4_self"], rows["self"]),
        # K5 on both bf16 paths: phase 5's greedy batch and phase 12's host beam
        ("cached_attention", "decode_attention.cu", "decode_attention.py:109",
         bf16["k5"] + host["k5"], rows["k5-b8"]),
        ("permute_rows_multi", "beam_gather.cu", "beam_gather.py:159", host["k6"],
         rows["k6-bf16"]),  # the host beam's float cache
        ("cow_copy_rows", "beam_gather.cu", "beam_gather.py:280", beam["k7"], rows["k7-96"]),
        # The training path's kernels (phase 15), at the encoder's shape: K1's
        # f32 kernel (K1c's forward) alone, K1c's backward kernel alone, and
        # K1c forward and backward, with the forward's launches, every one
        # through flash_sdpa
        ("flash_attention.f32", "flash_attention.cu", "flash_attention.py:141",
         train["k1_f32"], train_rows["k1-f32"]),
        ("flash_sdpa.backward", "flash_attention_bwd.cu", "flash_attention.py:193",
         train["k1c_bwd"], train_rows["k1c-bwd-1500-float32"]),
        ("flash_sdpa", "flash_attention.cu", "flash_attention.py:183", train["k1_f32"],
         train_rows["k1c-1500-float32"]),
        # K1b on no model path: the launches of its entry point, ops.sdpa
        ("flash_attention.qk_int8", "flash_attention.cu", "flash_attention.py:141",
         k1b_entry["k1b"], train_rows["k1b-bfloat16-full"]),
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
