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
   8 and 64; phase 18's beam bench at 48), at causal and ragged shapes and at the edges of the bf16
   kernel's tiles (one query, one key, fewer keys than a tile, causal with
   Tq != Tk), with CUDA-event times taken in turns (plain, kernel, kernel,
   plain), TFLOP/s and the share of the bound; at every 1500-position
   encoder shape also F.scaled_dot_product_attention's time.
4. parity: a small f32 checkpoint transcribed on the CPU (plain attention)
   and on the card (the kernel); encoder output, first-step logits and
   greedy tokens must agree.
5. main path: a synthetic large-v3 checkpoint (random weights from a seed),
   loaded in bf16 on the card, transcribes a batch of 8 30 s clips through
   load_model + BatchTranscriber.transcribe_batch, with timestamps; the
   decoder's self-attention runs cached_attention (K5) n_text_layer times
   per forward.
6. int8 kernels: fused_quant (K2 "act", K3 "ln" and "gelu"; also "act" at
   gelu's shape, its byte floor, and at the edges of its vector layout: an
   odd D, a base off a 16-byte boundary) and
   cross_attention_int8 (K4, cross and causal self) against their plain
   versions at the int8 main path's shapes (also at phase 18's beam bench
   encoder at batch 48; K4 also at phase 11's and phase 18's beam fold and
   self cache, and at the edges of its key split: 1, 7 and 203 keys), timed in turns as
   in phase 3, K4's decode shapes also in a CUDA graph, each held to the
   plain version. Every case draws its inputs from a generator of its own,
   seeded from its name. K4's f32 check adds a flipped bf16 rounding of
   p * v_scale at the keys near a rounding midpoint (the flip term, see
   K4_TOL), and "cross-f32" is held to it on K4_SWEEP seeds; three planted
   faults must fail: the tanh GELU kernel against the erf plain version (the
   fused_quant bound), and at "cross-f32" the plain version without its last
   key and the plain output rounded to bf16 (the K4 check).
7. int8 parity: phase 4's checkpoint prepared for serving
   (prepare_serving_params: int8 decoder, W8A8 encoder, fused QKV) runs
   make_serving_step(kv_dtype="int8") on the CPU (plain versions) and on the
   card (the kernels); first-step logits and greedy tokens must agree.
8. int8 main path: phase 5's large-v3 model prepared the same way runs
   make_serving_step at batch 64, 64 tokens, int8 cross memory and cache,
   twice, with the launch count of every kernel checked per step.
9. decode kernels: cached_attention (K5, bf16 and f32, at the greedy step,
   its prefill bucket, the host beam's step and prompt prefill, and at the
   edges of its copies: C = 75, n_past 0 and C - 1, an f32 cache walked in
   two tiles, a base that is not 16-byte aligned; each also in a CUDA
   graph), permute_rows_multi (K6, on
   the 160-row int8 cache's four leaves with repeated rows, and on a bf16
   K/V pair) and cow_copy_rows (K7, the int8 cache with 1, 8, 32 and 96
   forked rows from cow_assign, phase 18's 240-row cache with 144, and
   phase 25's 165-row pool of 104 positions at its typical step and in a
   storm of 132; phase 24's bf16 pool of 85 rows of 328 positions)
   against their plain versions, timed in turns, with
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
   bucket; phase 20's fine-tune at batch 16: its encoder over 64 positions
   and its causal decoder over 31), and the backward kernel alone against the plain backward
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
16. whisper_full parity: phase 4's f32 checkpoint transcribes a 35 s WAV
   (read back through load_wav) on the CPU (plain versions) and on the card
   (kernels): greedy with word timestamps, beam 3 by the device beam, and
   beam 3 with patience by the host loop's device top-k step. Text and
   every segment's tokens, seek, t0 and t1 identical; word times within one
   0.02 s tick; K1 once per encoder layer and window, K5, and K7 or K6
   launched on the card.
17. whisper_full main path: phase 5's large-v3 bf16 model transcribes a
   WF_SECONDS WAV with language=None (language ID on the first window, its
   encoding reused), temperature (0.0, 0.4) with best_of 2, word timestamps
   and audio_ctx "auto", twice, the second run timed: windows, rungs per
   window, stage walls (mel, lang_id, encode, decode, word_align, each
   ending in a sync), seconds of audio per wall second, peak memory; K1
   launched n_audio_layer times per window encoded and K5 n_text_layer
   times per decoder forward (decode_step or cross_attention_probs). The
   first run also holds K1 and K5 to their plain versions on the path's own
   inputs at the first call of each shape (K1_CASES and K5_CASES carry the
   path's shapes too: the short "auto" windows, language ID's cache of 8,
   the word-timing prefill).
18. bench: python -m whisper_tpu_torch.utils.benchmark in a subprocess,
   twice, for BENCH_SECONDS each: large-v3 int8 greedy at batch 64 and
   beam 5 at bench.py's batch 48; each one JSON line is parsed and printed,
   and its kernels must have launched at every timed step. The memory
   guard's estimate is printed beside the peak allocated and reserved
   memory of phases 8, 11 and 18 (phases 8 and 11 with phase 5's model
   resident too), the guard must admit every serving configuration the
   smoke runs (guarded(), from the phases' own constants), and each bench
   process's peak reserved memory must stay within PEAK_OVER_ESTIMATE
   times the estimate (the guard's calibration).
19. chunked, streaming, CLI: phase 4's f32 checkpoint through
   transcribe_chunked (disjoint and 5 s overlap), StreamingTranscriber fed
   5 s increments and python -m whisper_tpu_torch.cli transcribe
   --output-json, on the CPU (plain versions) and on the card (kernels):
   text and segments identical (the stream's also equal to offline
   transcribe). Then phase 5's large-v3 bf16 model runs transcribe_chunked
   on phase 17's WAV twice (3 windows in one batch, language ID, the
   lockstep device loop): audio seconds per wall second, stage walls, K1
   once per encoder layer and K5 n_text_layer times a forward; the first
   run holds K1 and K5 to their plain versions at every shape it gives them.
   Last, load_model of phase 5's GGML with the native reader and the
   Python one, in turns: the wall of each.
20. tone-word round trip (tests/test_wer_roundtrip.py on the card): a micro
   config (state 64, 2 + 2 layers, one head: the kernels take d_head 64
   only, so the JAX test's two heads of 32 become one of 64) trained from
   scratch by finetune for 700 steps at batch 16 on utils/synth tone words,
   written with write_ggml, reloaded with load_model(use_native=True) (the
   native reader asserted), and scored by python -m whisper_tpu_torch.cli
   eval over held-out WAVs: WER below 0.6, the JAX test's bound. The same
   WAVs with int8 decoder weights: WER and the share of utterances whose
   tokens equal the f32 run's. Every shape the fine-tune gives flash_sdpa
   must be one of phase 13's K1C_CASES, and the in-process decode holds K1
   and K5 to their plain versions at every shape it gives them.
21. engine parity: phase 4's checkpoint through the SlotEngine
   (parallel/engine.py) on the CPU and on the card: five streams on 2
   slots under all four schedules, float and int8 (int8 decoder weights
   and pools), each stream's tokens equal to the device loop's on the
   engine's model; then transcribe_streams over a 35 s and an 8 s clip
   gives pipeline.transcribe's segments. On the card the ragged K5 (float)
   and K4 (int8) must have launched, and the overlapped schedule runs under
   torch.cuda.set_sync_debug_mode with its stages recorded (engine.spans):
   it must make no synchronizing CUDA call (its harvest pulls wait on CUDA
   events, which that mode does not flag), and its recorded admission
   buckets must hold each stream's window once.
22. float engine: phase 5's large-v3 bf16 model, transcribe_streams with 16
   slots (bf16 pools, K5 reading each slot's n_past in device memory) over
   phase 17's WAV and three cuts of it, windows of up to 64 tokens at t=0,
   twice: audio seconds per wall second, the engine's stats, launches (K5
   n_text_layer times a forward); run 1 holds K1 and K5 to their plain
   versions at every shape the path gives them. K4_CASES and K5_CASES hold
   both kernels with each row's n_past in device memory at the engines'
   shapes (rows spread over 0..C-1, f32 and bf16, a K4 split over two ranks
   with rows at n_past 0, and every row alike, equal to the int call).
23. engine bench: python -m whisper_tpu_torch.utils.benchmark with
   BENCH_MODE=engine in a subprocess (large-v3 int8, 64 slots, 128 streams
   of 24/27/30 s, chunks of 32, 64 tokens, BENCH_SECONDS 20): its JSON line,
   stats and peaks beside the guard's estimate (within PEAK_OVER_ESTIMATE),
   and K1, K4 cross, K4 self and the ragged K4 self launched in the timed
   waves. Every shape it gives the kernels is in K1_CASES and K4_CASES by
   construction at these defaults: the pool has 65 rows and the prompt
   bucket 32 tokens, and the bench's stats must show that every admission
   bucket was a full 16 (staged buckets × 16 = 128 streams).
24. beam engine parity: phase 4's checkpoint through the BeamSlotEngine
   (parallel/beam_engine.py) on the CPU and on the card: beam 3, six streams
   of 2-12 s on 2 groups (groups reused, a partial bucket), on the card
   under all four schedules (the CPU runs the pipelined one; the CPU tests
   cover the rest), float and int8, each stream's tokens equal to the
   device beam's (beam_decode_device on the engine's model, its finalize)
   on that device and the card's equal to the CPU's; the overlapped
   schedule on the card makes no synchronizing CUDA call besides its
   harvest pulls; K7 and the ragged K5 (float) or K4 (int8) must have
   launched in the engine's runs (the device beam's references run before
   the counts are set to 0); then beam-2 transcribe_streams on the card
   over a 35 s and an 8 s clip gives pipeline.transcribe's segments. Then
   the float engine at full width, as `cli serve --beam 5` loads it: phase
   5's large-v3 bf16 model, beam 5 over 16 groups (85 rows of bf16 pools
   of 328 positions), transcribe_streams over phase 22's four streams,
   windows of up to 64 tokens, K1 and K5 held to their plain versions at
   every shape the path gives them; K7 once a step and the ragged K5 once a
   layer a step; each window's tokens beside the device beam's on that
   window alone with the window's prompt and budget (compared, not held:
   bf16 rounds the engine's 85-row sums apart from the device beam's 5-row
   ones, which moves near-tied beams); then the same at f32 (large-v3
   drawn on the card), where every window must equal the device beam's.
25. beam engine bench: python -m whisper_tpu_torch.utils.benchmark with
   BENCH_MODE=engine BENCH_BEAM=5 in a subprocess (large-v3 int8 at
   bench.py's beam engine defaults: 32 groups of 5 rows and the trash group,
   64 streams, chunks of 16, 64 tokens, BENCH_SECONDS 20): its JSON line and
   stats, the forked rows a step (mean and most), K7 once a decode step,
   the ragged K4 self and the K4 cross fold once a layer a step, K4 cross
   and self once a layer at each prefill (one row a group, the greedy
   engine's shapes), the peaks beside the guard's estimate at beam 5
   (within PEAK_OVER_ESTIMATE); every admission bucket a full 16, which
   keeps its shapes in K4_CASES ("beam-engine-*", "engine-*-t32") and
   K7_CASES.
26. server: EngineServer behind make_http_server on 127.0.0.1 (port 0):
   phase 4's checkpoint greedy and with beam 2 answers /transcribe,
   ?stream=1 and /v1/audio/transcriptions with the same engine's
   transcribe_streams results; then phase 22's large-v3 bf16 float engine
   serves phase 22's four streams as concurrent HTTP requests, whose texts
   must be phase 22's: wall, audio seconds per wall second, latency
   percentiles, launches. Last, the CLI as a user runs it, in subprocesses
   on the card with phase 4's checkpoint: batch --beam 2 prints this
   process's BeamSlotEngine's texts, and serve --beam 5 answers /healthz
   and a POST /transcribe of an 8 s clip, then exits 0 on SIGTERM.
Phases 16, 17, 19, 21, 22, 24 and 26 run after phase 12, while phase 5's
model is loaded; phases 18, 23 and 25 after them, phase 20 last.

The line before the last is the kernels JSON: every kernel with its
main-path launches (K1 and K5 with phases 17, 19, 22, 24, 25 and 26 added, the
int8 step's kernels with phase 18's timed steps, the beam bench's K4 and K7,
the engines' K4 and ragged K5, the int8 beam engine's K4 fold, prefill,
ragged self and K7 (its storm's times beside the typical step's), the
float beam engine's ragged K5 and K7 (phase 24's large-v3 run) and phase
20's fine-tune in
rows of their own at their shapes, K1c with phase 15's),
error against its plain version, kernel, plain and
library times (K4 cross and self and K5 also the time of one call in a CUDA
graph, "graph_ms"), and its bound (bytes over 3.35 TB/s or operations over the
peak rate of their type, whichever is larger; under a causal mask only the
keys it lets through count; the split-TF32 kernels' f32 operations at the
smaller of 67 TFLOP/s of f32 and three TF32 products at 495 TFLOP/s). It
imports nothing of jax and nothing of the JAX package. TF32 is switched off for matmuls and cuDNN
convolutions, so the f32 comparisons are full f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import http.client
import io
import json
import math
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import traceback
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.config import (CARD_MEMORY_FRACTION, PEAK_OVER_ESTIMATE, PRESETS,
                                      SAMPLE_RATE, WhisperConfig, check_serving_hbm)
from whisper_tpu_torch.decoding.device_beam import beam_decode_device, cow_assign
from whisper_tpu_torch.decoding.device_loop import decode_segment_device
from whisper_tpu_torch.decoding.sequence import BeamSearchDecoder
from whisper_tpu_torch.decoding.task import DecodingOptions, decode_full
from whisper_tpu_torch.frontend.mel import (frame_count, log_mel_spectrogram, mel_filter_bank,
                                            mel_window)
from whisper_tpu_torch.io.ggml import tensor_schema, write_ggml
from whisper_tpu_torch.io.vocab import make_vocab
from whisper_tpu_torch.io.wav import load_wav, load_wav_bytes, write_wav
from whisper_tpu_torch.kernels import beam_gather, build
from whisper_tpu_torch.kernels import fused_quant
from whisper_tpu_torch.kernels.launches import COUNTERS
from whisper_tpu_torch.kernels.cross_attention_int8 import (cross_attention_int8,
                                                            cross_attention_int8_plan,
                                                            cross_attention_int8_reference)
from whisper_tpu_torch.kernels.decode_attention import (cached_attention,
                                                        cached_attention_plan,
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
from whisper_tpu_torch.model.params import params_to_ggml
from whisper_tpu_torch.model.quant import (QuantKV, init_quant_cache, qk_logits, quantize_act,
                                           quantize_decoder_weights, quantize_kv)
from whisper_tpu_torch.parallel.beam_engine import BeamSlotEngine
from whisper_tpu_torch.parallel.engine import SCHEDULES, SlotEngine, _GraphHome, _decode_step
from whisper_tpu_torch.parallel.server import EngineServer, make_http_server
from whisper_tpu_torch.parallel.serving import BatchTranscriber
from whisper_tpu_torch.pipeline.chunked import transcribe_chunked
from whisper_tpu_torch.pipeline.streaming import StreamingTranscriber
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions, transcribe
from whisper_tpu_torch.runtime import native
from whisper_tpu_torch.training import finetune as finetune_module
from whisper_tpu_torch.training.train import (init_train_state, leaves, make_optimizer,
                                              make_train_step)
from whisper_tpu_torch.utils import synth
from whisper_tpu_torch.utils.benchmark import (bench_config_from_env, engine_config_from_env,
                                               kernel_launches,
                                               make_serving_step, serving_ctx,
                                               prepare_serving_params)
from whisper_tpu_torch.utils.wer import wer

ROOT = Path(__file__).resolve().parent
# The large-v3 serving configurations of the phases, shared with phase 18's
# memory guard (guarded): phase 5's streams and sample length, phase 8's
# batch and tokens (phase 11's tokens too), phase 12's streams, phase 17's
# best_of.
MAIN_STREAMS, MAIN_SAMPLE_LEN = 8, 64
INT8_BATCH, INT8_TOKENS = 64, 64
HOST_BEAM_STREAMS = 4
WF_BEST_OF = 2
CKPT_DIR = ROOT / "build" / "synthetic"
LARGE_V3_CKPT = CKPT_DIR / "large-v3-f16-seed0.bin"  # phase 5's, reloaded in phase 19

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
# its magnitude, tighter than K1's 2^-6), an f32 one by f32 noise...
K4_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}
# ...and, at f32, by a flipped rounding (the flip term, k4_flip_term, per
# element). pv_out rounds p * v_scale to bf16 even for an f32 q
# (model/quant.py pv_out). The kernel's logits (a sequential fma sum over d),
# its expf and its sum may each sit an f32 ulp from the plain version's
# (cuBLAS's order, torch's exp), so its p * v_scale may sit a few f32 ulps
# from the plain one. Where the plain value lies within K4_NEAR_ULPS f32
# ulps of a bf16 rounding midpoint, the two may round it to neighbouring
# bf16 values, one bf16 ulp apart, and output column d moves by that ulp
# times the key's |v code| at d. The term sums that over the keys near a
# midpoint, per element: a key lies that near with odds ~2 * K4_NEAR_ULPS /
# 2^16 (2^16 f32 ulps to a bf16 one), ~0.4 of the 1500 keys of a row, and
# most rows get no term at all. Measured (k4_f32_flip, 32 seeds of
# "cross-f32"): every flip that moved an element past K4_TOL came from a key
# within 3 f32 ulps of its midpoint. The bf16 bound already covers a flip:
# its output rounds to bf16 anyway. Phase 6 plants two faults that must fail
# this check: a dropped key (moves a row by about p * v of that key) and the
# f32 output rounded to bf16 (moves an element by up to 2^-9 of it).
K4_NEAR_ULPS = 8
K4_SWEEP = 8  # seeds of "cross-f32" held to the f32 check in phase 6
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


def case_n_past(spec, bsz: int, c: int):
    """A kernel case's n_past: None (cross-attention), an int, "spread" (a
    (B,) int32 tensor on the card with row b at round(b (C - 1) / (B - 1)):
    every row at its own position, 0 and C - 1 among them, as the engine's
    slots), ("groups", k) ("spread" over the B / k groups, the k rows of a
    group at its one position, as the beam engine's groups) or ("rows", v)
    (every row at v, as such a tensor)."""
    if spec == "spread":
        return torch.linspace(0, c - 1, bsz, device="cuda").round().to(torch.int32)
    if isinstance(spec, tuple) and spec[0] == "groups":
        k = spec[1]
        return case_n_past("spread", bsz // k, c).repeat_interleave(k)
    if isinstance(spec, tuple):
        return torch.full((bsz,), spec[1], dtype=torch.int32, device="cuda")
    return spec


def n_past_text(n_past) -> str:
    if isinstance(n_past, torch.Tensor):
        return (f"per row {int(n_past.min())}..{int(n_past.max())} (a ({n_past.numel()},) "
                f"tensor on the card)")
    return str(n_past)


def row_keys(n_past, bsz: int, tq: int, c: int) -> tuple:
    """causal_keys summed over the batch rows, each at its own n_past when
    n_past is a tensor: (key positions read, query-key pairs)."""
    if isinstance(n_past, torch.Tensor):
        per = [causal_keys(n, tq, c) for n in n_past.tolist()]
        return sum(k for k, _ in per), sum(p for _, p in per)
    keys, pairs = causal_keys(n_past, tq, c)
    return bsz * keys, bsz * pairs


def plan_n_past(n_past, tq: int, c: int):
    """The n_past a wrapper sizes its launch plan with: a tensor's plan covers
    the whole cache (the host does not read the rows)."""
    return max(0, c - tq) if isinstance(n_past, torch.Tensor) else n_past


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
    # a short window under audio_ctx "auto" (512-frame buckets: 256·k
    # positions); phase 17's last window is the 512
    (1, 20, 256, 256, False, torch.bfloat16),
    (1, 20, 512, 512, False, torch.bfloat16),
    (1, 20, 768, 768, False, torch.bfloat16),
    # transcribe_chunked's batched encodes: phase 19's 3 windows, and its
    # largest batch of 16 windows
    (3, 20, 1500, 1500, False, torch.bfloat16),
    (16, 20, 1500, 1500, False, torch.bfloat16),
    (48, 20, 1500, 1500, False, torch.bfloat16),  # phase 18's beam bench encodes b48
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
        if tq == tk == 1500:  # TF32 off: the f32 library call is f32 too
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
    path = LARGE_V3_CKPT
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
    audios = [synthetic_audio(SAMPLE_RATE * 30, seed=100 + i) for i in range(MAIN_STREAMS)]
    bt = BatchTranscriber(model, MAIN_STREAMS, options=DecodingOptions(
        sample_len=MAIN_SAMPLE_LEN,
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
        log(f"[main] run {run}: {MAIN_STREAMS} x 30 s, bf16, greedy, timestamps, sample_len "
            f"{MAIN_SAMPLE_LEN}: "
            f"mel {tm['mel'] * 1e3:.1f} ms, encode {tm['encode'] * 1e3:.1f} ms, "
            f"decode {tm['decode'] * 1e3:.1f} ms, total {wall * 1e3:.1f} ms; "
            f"{n_tok} tokens; peak {peak / 1e9:.2f} GB; flash_attention launches {n_launch}, "
            f"cached_attention {n_k5} ({n_k5 // cfg.n_text_layer} forwards); {card}")
        if len(results) != MAIN_STREAMS:
            raise AssertionError(f"expected {MAIN_STREAMS} results, got {len(results)}")
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


FQ_CASES = [  # (name, mode, rows, d, dtype, elements before x's base)
    # the int8 main path's sites, large-v3 at batch 64
    ("act", "act", 64 * 1500, 1280, torch.bfloat16, 0),  # attention output; before cross-K/V
    ("ln", "ln", 64 * 1500, 1280, torch.bfloat16, 0),    # LN -> QKV and LN -> MLP0
    ("gelu-erf", "gelu-erf", 64 * 1500, 5120, torch.bfloat16, 0),  # GELU -> MLP1
    ("gelu-tanh", "gelu-tanh", 2 * 1500, 5120, torch.bfloat16, 0),  # ggml's GELU, off the path
    ("ln-f32", "ln", 2 * 1500, 1280, torch.float32, 0),  # the f32 parity path (phase 7)
    ("gelu-erf-f32", "gelu-erf", 2 * 1500, 5120, torch.float32, 0),
    ("act-5120", "act", 64 * 1500, 5120, torch.bfloat16, 0),  # gelu's bytes, without its GELU
    # edges of the vector layout: D not a multiple of 8 (scalar loads and
    # stores), a base 2 bytes past a 16-byte boundary
    ("ln-d1283", "ln", 2 * 1500, 1283, torch.bfloat16, 0),
    ("act-d1283", "act", 2 * 1500, 1283, torch.bfloat16, 0),
    ("ln-offset", "ln", 2 * 1500, 1280, torch.bfloat16, 1),
    ("act-offset", "act", 2 * 1500, 1280, torch.bfloat16, 1),
    # phase 18's beam bench: the W8A8 encoder at batch 48
    ("act-b48", "act", 48 * 1500, 1280, torch.bfloat16, 0),
    ("ln-b48", "ln", 48 * 1500, 1280, torch.bfloat16, 0),
    ("gelu-erf-b48", "gelu-erf", 48 * 1500, 5120, torch.bfloat16, 0),
]
BEAM_GROUPS, BEAM = 32, 5  # phase 11: 32 windows x 5 beams = 160 decoder rows
# phase 23's engine bench (bench.py's greedy engine defaults): the slots, the
# admission bucket and the pool's positions (the 32-token prompt bucket, 64
# tokens and 8 spare)
ENGINE_SLOTS, ENGINE_BUCKET, ENGINE_CTX = 64, 16, 32 + 64 + 8
# phase 22's float engine: slots, and the pool transcribe_streams sizes for
# 64-token windows (the longest wrapped prompt, 256, + 64 + 8)
FLOAT_ENGINE_SLOTS, FLOAT_ENGINE_TOKENS = 16, 64
FLOAT_ENGINE_CTX = 256 + FLOAT_ENGINE_TOKENS + 8
# phase 18's beam bench: bench.py's batch with a beam (48 windows x 5 beams = 240 rows)
BENCH_BEAM_GROUPS = bench_config_from_env({"BENCH_BEAM": str(BEAM)})["batch"]
# phase 25's beam engine bench (bench.py's beam engine defaults): 32 groups
# and the trash group of 5 rows (165), the pool of ENGINE_CTX positions,
# admission buckets of ENGINE_BUCKET windows prefilled at one row a group
BEAM_ENGINE_GROUPS = engine_config_from_env({"BENCH_BEAM": str(BEAM)})["n_slots"] + 1
BEAM_ENGINE_FORKS = 73  # K7's typical step there: phase 25 reads 73.07 forked rows a step
# phase 24's float beam engine at full width: phase 22's slots as groups of
# BEAM rows and the trash group (85 rows), phase 22's pool; K7's typical step
FLOAT_BEAM_GROUPS = FLOAT_ENGINE_SLOTS + 1
# phase 24's runs fork 3.85-6.00 rows a step (with the checkpoint's weights
# 6.00 at bf16 and 4.38 at f32; 3.85-4.48 with other random bf16 weights)
FLOAT_BEAM_FORKS = 4
K4_CASES = [  # (name, batch, heads, tq, keys, n_past, dtype); n_past None: cross
    ("cross", 64, 20, 1, 1500, None, torch.bfloat16),  # decode step, large-v3 b64
    ("cross-t3", 64, 20, 3, 1500, None, torch.bfloat16),  # prefill of the 3-token prompt
    ("cross-f32", 64, 20, 1, 1500, None, torch.float32),
    ("self", 64, 20, 1, 75, 40, torch.bfloat16),  # a layer of the int8 self cache
    ("self-3", 64, 20, 1, 75, 3, torch.bfloat16),
    ("self-74", 64, 20, 1, 75, 74, torch.bfloat16),
    ("self-t32", 4, 20, 32, 75, 0, torch.bfloat16),  # a 32-token prefill bucket
    ("cross-beam5", BEAM_GROUPS, 20, BEAM, 1500, None, torch.bfloat16),  # phase 11's beam fold
    # phase 11's prefill of the 3-token prompt, folded: 15 query rows, two row blocks
    ("cross-beam-prefill", BEAM_GROUPS, 20, 3 * BEAM, 1500, None, torch.bfloat16),
    # the self cache of the greedy step's prefill (phases 8 and 18), and of
    # the beam steps, one row a beam: phase 11's 160 rows, phase 18's 240
    ("self-t3", 64, 20, 3, 75, 0, torch.bfloat16),
    ("self-beam", BEAM_GROUPS * BEAM, 20, 1, 75, 40, torch.bfloat16),
    ("self-beam-t3", BEAM_GROUPS * BEAM, 20, 3, 75, 0, torch.bfloat16),
    # phase 18's beam bench at 48 windows: the fold, its prefill, the self cache
    ("cross-beam5-b48", BENCH_BEAM_GROUPS, 20, BEAM, 1500, None, torch.bfloat16),
    ("cross-beam-prefill-b48", BENCH_BEAM_GROUPS, 20, 3 * BEAM, 1500, None, torch.bfloat16),
    ("self-beam-b48", BENCH_BEAM_GROUPS * BEAM, 20, 1, 75, 40, torch.bfloat16),
    ("self-beam-t3-b48", BENCH_BEAM_GROUPS * BEAM, 20, 3, 75, 0, torch.bfloat16),
    # edges of the key split: one key, keys not a multiple of 4 (rows of K
    # at odd byte offsets), a count that leaves the last rank short
    ("cross-c1", 4, 20, 1, 1, None, torch.bfloat16),
    ("cross-c7", 4, 20, 5, 7, None, torch.float32),
    ("cross-c203", 4, 20, 3, 203, None, torch.bfloat16),
    # the engine (phase 23's bench: 64 slots and the trash row, admission
    # buckets of 16 with the 32-token prompt bucket, a pool of 32 + 64 + 8
    # positions): cross at the step and the prefill, self at the prefill, and
    # self with each slot at its own n_past read from device memory (rows
    # spread over 0..C-1), also in f32 (phase 21's tiny model), over 1500
    # keys (two ranks: rows at n_past 0 leave the second rank no key), and
    # with every row alike, which must equal the int call
    ("engine-cross", ENGINE_SLOTS + 1, 20, 1, 1500, None, torch.bfloat16),
    ("engine-cross-t32", ENGINE_BUCKET, 20, 32, 1500, None, torch.bfloat16),
    ("engine-self-t32", ENGINE_BUCKET, 20, 32, ENGINE_CTX, 0, torch.bfloat16),
    ("engine-self", ENGINE_SLOTS + 1, 20, 1, ENGINE_CTX, "spread", torch.bfloat16),
    ("engine-self-f32", ENGINE_SLOTS + 1, 20, 1, ENGINE_CTX, "spread", torch.float32),
    ("engine-self-c1500", 8, 20, 1, 1500, "spread", torch.bfloat16),
    ("engine-self-rows", ENGINE_SLOTS + 1, 20, 1, ENGINE_CTX, ("rows", 40), torch.bfloat16),
    # the beam engine (phase 25): the cross fold each step (5 query rows a
    # group over its shared memory) and the ragged self over the pool with
    # each group's 5 rows at one n_past; its admission prefill (one row a
    # group) runs at engine-cross-t32 and engine-self-t32
    ("beam-engine-cross", BEAM_ENGINE_GROUPS, 20, BEAM, 1500, None, torch.bfloat16),
    ("beam-engine-self", BEAM_ENGINE_GROUPS * BEAM, 20, 1, ENGINE_CTX, ("groups", BEAM),
     torch.bfloat16),
]
# also timed in a CUDA graph: device time without the wrapper
K4_GRAPHED = ("cross", "self", "engine-self", "beam-engine-cross", "beam-engine-self")


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


def _fq_case(card: str, gen, rows: dict, name: str, mode: str, n: int, d: int, dtype,
             off: int) -> None:
    """One fused_quant case against its plain version; adds its row."""
    x = (torch.randn(off + n * d, device="cuda", generator=gen) * 2).to(dtype)[off:].view(n, d)
    w, b = (torch.randn(d, device="cuda", generator=gen).to(dtype) for _ in range(2))
    kern, plain = _fq_calls(mode, x, w, b)
    got = kern()
    torch.cuda.synchronize()
    ok, scale_rel, levels, share, err = _fq_agreement(mode, got, plain())
    ms, plain_ms, t = in_turns(plain, kern, 20)
    gbps = n * d * (x.element_size() + 1) / (ms * 1e-3) / 1e9
    bound = FQ_BOUNDS[mode.split("-")[0]]
    log(f"[int8-kernel] fused_quant {name}: {mode} ({n}, {d}) {str(dtype)[6:]}, base "
        f"+{off * x.element_size()} bytes, {fused_quant.fused_quant_plan(d).warps_per_row} "
        f"warp(s) a row: scale max rel "
        f"{scale_rel:.3e}, codes max {levels} levels apart on {share:.3e} of them, "
        f"dequant max_abs_err {err:.3e} (bound: scale rtol {bound[0]:.1e}, {bound[1]} "
        f"level(s) on < {bound[2]:.0e}); kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
        f"plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}); kernel {gbps:.0f} GB/s "
        f"(read + write); {card}")
    if not ok:
        raise AssertionError(f"fused_quant {name} disagrees with its plain version")
    if name == "gelu-erf":
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
    rows[name] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": by, "library_ms": None}


def case_generator(name: str, seed: int = 0) -> torch.Generator:
    """A generator of the case's own, seeded from its name (and a sweep
    index): no case's inputs depend on which cases drew before it."""
    return torch.Generator(device="cuda").manual_seed(zlib.crc32(f"{name}:{seed}".encode()))


def k4_inputs(gen, bsz: int, h: int, tq: int, c: int, n_past, dtype) -> tuple:
    """(q, k8, k_scale, v8, v_scale, n_past) of one K4 case: a contiguous
    cross memory (B, H, D, C), or layer 2 of a (B, L, H, D, C) int8 cache."""
    q = (torch.randn(bsz, h, tq, 64, device="cuda", generator=gen) * 0.3).to(dtype)
    if n_past is None:
        k8, ks = quantize_kv(torch.randn(bsz, h, 64, c, device="cuda", generator=gen))
        v8, vs = quantize_kv(torch.randn(bsz, h, 64, c, device="cuda", generator=gen))
    else:
        kc, vc = (quantize_kv(torch.randn(bsz, 4, h, 64, c, device="cuda", generator=gen))
                  for _ in range(2))
        k8, ks, v8, vs = kc.data[:, 2], kc.scale[:, 2], vc.data[:, 2], vc.scale[:, 2]
    return q, k8, ks, v8, vs, n_past


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits): 2^(e - 8)
    for |x| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def k4_flip_term(q, k8, ks, v8, vs, n_past) -> torch.Tensor:
    """The f32 flip term (see K4_TOL) per output element (B, H, T, D): over
    the keys whose plain f32 p * v_scale lies within K4_NEAR_ULPS f32 ulps of
    a bf16 rounding midpoint, the sum of one bf16 ulp of it times the key's
    |v code| at d."""
    logits = qk_logits(q, QuantKV(k8, ks))
    if n_past is not None:
        logits = logits.masked_fill(~causal_mask(n_past, q.shape[2], k8.shape[-1], q.device),
                                    -1e30)
    x = torch.softmax(logits, dim=-1) * vs.unsqueeze(-2)  # the value pv_out rounds
    ulp16 = bf16_ulp(x)
    mid = (x.view(torch.int32) & -65536).view(torch.float32) + ulp16 / 2  # exact in f32
    _, e = torch.frexp(x)
    near = (x - mid).abs() <= K4_NEAR_ULPS * torch.ldexp(torch.ones_like(x), e - 24)
    return torch.matmul(torch.where(near, ulp16, 0.0), v8.float().abs().transpose(-1, -2))


def k4_agreement(out, ref, args) -> tuple:
    """(every element within K4_TOL, plus the flip term at f32; max abs
    error; the largest term) of a K4 output against ``ref``."""
    q = args[0]
    diff = (out.float() - ref.float()).abs()
    atol, rtol = K4_TOL[q.dtype]
    bound = atol + rtol * ref.float().abs()
    term = 0.0
    if q.dtype == torch.float32:
        flip = k4_flip_term(*args)
        bound, term = bound + flip, flip.max().item()
    return bool((diff <= bound).all()), diff.max().item(), term


def _k4_f32_sweep(card: str) -> None:
    """"cross-f32" on K4_SWEEP seeds, each held to K4_TOL with the f32 term;
    then two planted faults that must fail the same check: the plain version
    without its last key, and the plain output rounded to bf16."""
    name, bsz, h, tq, c, n_past, dtype = next(x for x in K4_CASES if x[0] == "cross-f32")
    for seed in range(K4_SWEEP):
        args = k4_inputs(case_generator(name, seed), bsz, h, tq, c, n_past, dtype)
        out = cross_attention_int8(*args)
        ok, err, term = k4_agreement(out, cross_attention_int8_reference(*args), args)
        log(f"[int8-kernel] cross_attention_int8 {name} seed {seed}: max_abs_err {err:.3e} "
            f"(atol {K4_TOL[dtype][0]:.0e} + rtol {K4_TOL[dtype][1]:.0e} + the flip term, "
            f"at most {term:.3e} in an element): {'within' if ok else 'OUTSIDE'}")
        if not ok:
            raise AssertionError(f"cross_attention_int8 {name} seed {seed} disagrees with its "
                                 f"plain version: max_abs_err {err}")
    q, k8, ks, v8, vs, _ = args
    ref = cross_attention_int8_reference(*args)
    faults = {"the plain version without its last key": cross_attention_int8_reference(
                  q, k8[..., :-1], ks[..., :-1], v8[..., :-1], vs[..., :-1]),
              "the plain output rounded to bf16": ref.to(torch.bfloat16).float()}
    for fault, got in faults.items():
        passes, err, _ = k4_agreement(got, ref, args)
        log(f"[int8-kernel] planted fault, {fault} at {name}: max_abs_err {err:.3e}, "
            f"{'passes: NOT caught' if passes else 'fails the check: caught'}")
        if passes:
            raise AssertionError(f"the K4 f32 check does not tell {fault}")


def phase_int8_kernels(card: str) -> dict:
    """K2/K3 and K4 vs their plain versions; returns a row per case."""
    rows = {}
    for case in FQ_CASES:
        _fq_case(card, case_generator(case[0]), rows, *case)
    _k4_f32_sweep(card)
    for name, bsz, h, tq, c, spec, dtype in K4_CASES:
        gen = case_generator(name)
        n_past = case_n_past(spec, bsz, c)
        args = k4_inputs(gen, bsz, h, tq, c, n_past, dtype)
        q = args[0]
        out = cross_attention_int8(*args)
        torch.cuda.synchronize()
        ref = cross_attention_int8_reference(*args)
        ok, err, term = k4_agreement(out, ref, args)
        atol, rtol = K4_TOL[dtype]
        ms, plain_ms, t = in_turns(lambda: cross_attention_int8_reference(*args),
                                   lambda: cross_attention_int8(*args), 50)
        keys, pairs = row_keys(n_past, bsz, tq, c)
        gbps = h * 2 * 64 * keys / (ms * 1e-3) / 1e9
        # only the keys the mask lets through (each row's own): codes and
        # scales of K and V
        b_ms, by = bound_ms(nbytes(q, out) + 2 * h * keys * (64 + 4), 4 * h * pairs * 64, dtype)
        plan = cross_attention_int8_plan(c, tq, plan_n_past(n_past, tq, c))
        g_ms = graph_ms(lambda: cross_attention_int8(*args), 50) if name in K4_GRAPHED else None
        graphed = f"; in a CUDA graph {g_ms:.4f} ms" if g_ms is not None else ""
        log(f"[int8-kernel] cross_attention_int8 {name} q ({bsz}, {h}, {tq}, 64) "
            f"{str(dtype)[6:]} over {c} keys, n_past {n_past_text(n_past)}, {plan.ranks} rank(s) of "
            f"{plan.chunk} keys: max_abs_err {err:.3e} (atol {atol:.0e}, rtol {rtol:.1e}"
            f"{f', + the flip term, at most {term:.3e} in an element' if term else ''}); "
            f"kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain {plain_ms:.4f} ms ({t[0]:.4f}, "
            f"{t[3]:.4f}){graphed}; bound {b_ms:.4f} ms ({by}); kernel {gbps:.0f} GB/s of int8 "
            f"K/V; {card}")
        if not ok:
            raise AssertionError(f"cross_attention_int8 {name} disagrees with its plain version: "
                                 f"max_abs_err {err}")
        if isinstance(spec, tuple) and spec[0] == "rows":
            same = torch.equal(out, cross_attention_int8(*args[:5], spec[1]))
            log(f"[int8-kernel] cross_attention_int8 {name}: every row at n_past {spec[1]} as a "
                f"tensor {'equals' if same else 'DIFFERS FROM'} the int call, bit for bit")
            if not same:
                raise AssertionError(f"cross_attention_int8 {name}: the tensor call differs "
                                     "from the int call")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": by, "library_ms": None, "graph_ms": g_ms}
    if (fused_quant.act_quant.launches == 0 or cross_attention_int8.masked_launches == 0
            or cross_attention_int8.ragged_launches == 0):
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
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def _read_launches() -> dict:
    return kernel_launches()


def phase_int8_main_path(card: str, model):
    """The int8 serving step at batch 64; returns (the first run's launches,
    the prepared model)."""
    cfg = model.config
    t0 = time.perf_counter()
    served = model.with_params(prepare_serving_params(model.params))
    torch.cuda.synchronize()
    log(f"[int8-main] prepare_serving_params on cuda: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (the bf16 model included)")
    batch, n_tok = INT8_BATCH, INT8_TOKENS
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
    ("beam-t3", 20, 20, 3, 448, 0, torch.bfloat16),     # its prefill of the 3-token prompt
    ("b8-f32", 8, 20, 1, 104, 40, torch.float32),
    ("b8-prefill-f32", 8, 20, 32, 104, 0, torch.float32),
    ("beam-f32", 20, 20, 1, 448, 40, torch.float32),
    # edges of the kernel's copies: rows 150 bytes apart (not 16-byte
    # aligned), the first and the last n_past, an f32 cache over all 448
    # positions (K and V in two tiles each), a base 2 bytes past an aligned one
    ("c75", 8, 20, 1, 75, 40, torch.bfloat16),
    ("c75-t3-f32", 8, 20, 3, 75, 0, torch.float32),
    ("n0", 8, 20, 1, 104, 0, torch.bfloat16),
    ("n103", 8, 20, 1, 104, 103, torch.bfloat16),
    ("beam-f32-full", 20, 20, 1, 448, 447, torch.float32),
    ("b8-offset", 8, 20, 1, 104, 40, torch.bfloat16),
    # phase 17's whisper_full shapes: detect_language's throwaway cache of 8,
    # cross_attention_probs' prefill over its own T (short, and a long
    # teacher-forced window), and a 223-token prompt bucketed to 256 over a
    # full cache for best_of 2
    ("lang-id", 1, 20, 1, 8, 0, torch.bfloat16),
    ("wt-27", 1, 20, 27, 27, 0, torch.bfloat16),
    ("wt-229", 1, 20, 229, 229, 0, torch.bfloat16),
    ("prompt-256", 2, 20, 256, 448, 0, torch.bfloat16),
    # phase 19's chunked lockstep over 3 windows: language ID's cache of 8,
    # the 32-token prompt bucket and the steps over its 264-position cache
    # (32 + 224 + 8)
    ("chunk-lang-id", 3, 20, 1, 8, 0, torch.bfloat16),
    ("chunk-b3-prefill", 3, 20, 32, 264, 0, torch.bfloat16),
    ("chunk-b3", 3, 20, 1, 264, 40, torch.bfloat16),
    # the engine: phase 22's float pool (16 slots and the trash row, 328
    # positions) and the default streams pool of 448, each slot at its own
    # n_past read from device memory (rows spread over 0..C-1), bf16 and f32
    # (an f32 pool of 448 walks K and V in two tiles), and every row alike,
    # which must equal the int call
    ("engine", FLOAT_ENGINE_SLOTS + 1, 20, 1, FLOAT_ENGINE_CTX, "spread", torch.bfloat16),
    ("engine-f32", FLOAT_ENGINE_SLOTS + 1, 20, 1, FLOAT_ENGINE_CTX, "spread", torch.float32),
    ("engine-448", FLOAT_ENGINE_SLOTS + 1, 20, 1, 448, "spread", torch.bfloat16),
    ("engine-448-f32", FLOAT_ENGINE_SLOTS + 1, 20, 1, 448, "spread", torch.float32),
    ("engine-rows", FLOAT_ENGINE_SLOTS + 1, 20, 1, 104, ("rows", 40), torch.bfloat16),
    # phase 24's float beam engine at full width: 85 rows of phase 22's
    # pool, each group's 5 rows at one n_past read from device memory
    ("beam-engine", FLOAT_BEAM_GROUPS * BEAM, 20, 1, FLOAT_ENGINE_CTX, ("groups", BEAM),
     torch.bfloat16),
]


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
    for name, bsz, h, tq, c, spec, dtype in K5_CASES:
        n_past = case_n_past(spec, bsz, c)
        q = (torch.randn(bsz, h, tq, 64, device="cuda", generator=gen) * 0.5).to(dtype)
        off = 1 if name.endswith("-offset") else 0  # elements before the cache's base
        kc, vc = (torch.randn(off + bsz * 4 * h * 64 * c, device="cuda", generator=gen)
                  .to(dtype)[off:].view(bsz, 4, h, 64, c) for _ in range(2))
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
        # only the keys the mask lets through (each row's own)
        keys, pairs = row_keys(n_past, bsz, tq, c)
        b_ms, by = bound_ms(nbytes(q, out) + 2 * h * 64 * keys * k.element_size(),
                            4 * h * pairs * 64, dtype)
        plan = cached_attention_plan(c, tq, plan_n_past(n_past, tq, c), k.element_size())
        log(f"[decode-kernel] cached_attention {name} q ({bsz}, {h}, {tq}, 64) {str(dtype)[6:]} "
            f"over {c} positions, n_past {n_past_text(n_past)}, base +{off * k.element_size()} bytes, "
            f"{plan.rows} row(s) a block, tiles of {plan.width} keys: max_abs_err {err:.3e} "
            f"(atol {atol:.0e}, rtol {rtol:.1e}); kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
            f"plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), F.scaled_dot_product_attention "
            f"{lib_ms:.4f} ms; kernel in a CUDA graph {g_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({by}, {keys} of {bsz * c} positions seen); {card}")
        if not ok:
            raise AssertionError(f"cached_attention {name} disagrees with its plain version: "
                                 f"max_abs_err {err}")
        if isinstance(spec, tuple) and spec[0] == "rows":
            same = torch.equal(out, cached_attention(q, k, v, spec[1]))
            log(f"[decode-kernel] cached_attention {name}: every row at n_past {spec[1]} as a "
                f"tensor {'equals' if same else 'DIFFERS FROM'} the int call, bit for bit")
            if not same:
                raise AssertionError(f"cached_attention {name}: the tensor call differs from "
                                     "the int call")
        rows[f"k5-{name}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                              "graph_ms": g_ms}
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


def _fork_src(n_forks: int, groups: int = BEAM_GROUPS) -> torch.Tensor:
    """copy_src of cow_assign over ``groups`` groups of 5 beams with
    ``n_forks`` forked rows spread over the groups: a group with f forks
    takes beam 0 f + 1 times and drops its last f beams."""
    rows = []
    for g in range(groups):
        f = n_forks // groups + (g < n_forks % groups)
        rows.append([0] * (f + 1) + list(range(1, BEAM - f)))
    new_src = torch.tensor(rows, device="cuda")
    phys = torch.arange(BEAM, device="cuda").repeat(groups, 1)
    _, copy_src = cow_assign(phys, new_src, BEAM)
    return (copy_src + torch.arange(groups, device="cuda")[:, None] * BEAM).reshape(-1)


K7_CASES = [  # (groups of BEAM rows, forked rows, positions, cache dtype); 96: phase 11's reading
    (BEAM_GROUPS, 1, 75, torch.int8), (BEAM_GROUPS, 8, 75, torch.int8),
    (BEAM_GROUPS, 32, 75, torch.int8), (BEAM_GROUPS, 96, 75, torch.int8),
    # phase 18's beam bench, 240 rows at phase 11's share
    (BENCH_BEAM_GROUPS, 144, 75, torch.int8),
    # phase 25's beam engine pool: 165 rows of ENGINE_CTX positions, at
    # BEAM_ENGINE_FORKS (the typical step) and in a storm (every group
    # forking 4 of its 5 rows)
    (BEAM_ENGINE_GROUPS, BEAM_ENGINE_FORKS, ENGINE_CTX, torch.int8),
    (BEAM_ENGINE_GROUPS, BEAM_ENGINE_GROUPS * (BEAM - 1), ENGINE_CTX, torch.int8),
    # phase 24's float beam engine: the bf16 pool of 85 rows, K and V
    (FLOAT_BEAM_GROUPS, FLOAT_BEAM_FORKS, FLOAT_ENGINE_CTX, torch.bfloat16),
]


def _k7_name(n_forks: int, ctx: int, dtype=torch.int8) -> str:
    return (f"k7-{n_forks}" + ("" if ctx == 75 else f"-c{ctx}")
            + ("" if dtype == torch.int8 else f"-{str(dtype)[6:]}"))


def _beam_cache(gen, rows: int, ctx: int, dtype):
    """A self cache of ``rows`` rows as cache_leaves gives it to K7: the
    int8 one's four leaves, or a float one's K and V (rows, 32, 20, 64,
    ctx)."""
    if dtype == torch.int8:
        return _int8_beam_cache(gen, rows, ctx)
    return [torch.randn((rows, 32, 20, 64, ctx), device="cuda", generator=gen).to(dtype)
            for _ in range(2)]


def _k7_cases(card: str, gen, rows: dict) -> None:
    for groups, ctx, dtype in dict.fromkeys((g, c, d) for g, _, c, d in K7_CASES):
        leaves = _beam_cache(gen, groups * BEAM, ctx, dtype)
        row_bytes = sum(a[0].numel() * a.element_size() for a in leaves)
        for n_forks in (n for g, n, c, d in K7_CASES if (g, c, d) == (groups, ctx, dtype)):
            src = _fork_src(n_forks, groups)
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
            log(f"[decode-kernel] cow_copy_rows {str(dtype)[6:]} cache ({groups * BEAM} rows of "
                f"{ctx} positions, {len(leaves)} leaves, {row_bytes / 1e6:.2f} MB a row), "
                f"{n_forks} forked rows: "
                f"{'bit-exact' if same else 'DIFFERS'}, identity rows "
                f"{'untouched' if untouched else 'CHANGED'}; kernel {ms:.4f} ms ({t[1]:.4f}, "
                f"{t[2]:.4f}), plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), index_copy_ "
                f"per leaf {lib_ms:.4f} ms; kernel in a CUDA graph {g_ms:.4f} ms; bound "
                f"{b_ms:.4f} ms ({by}); {card}")
            if not (same and untouched):
                raise AssertionError(f"cow_copy_rows with {n_forks} forks differs from its "
                                     f"plain version or touched an identity row")
            rows[_k7_name(n_forks, ctx, dtype)] = {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": lib_ms, "graph_ms": g_ms}
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
    step = make_serving_step(served, BEAM_GROUPS, INT8_TOKENS, "int8", beam_size=BEAM)
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
    audios = [synthetic_audio(SAMPLE_RATE * 30, seed=200 + i) for i in range(HOST_BEAM_STREAMS)]
    bt = BatchTranscriber(model, HOST_BEAM_STREAMS,
                          options=DecodingOptions(beam_size=BEAM, sample_len=32))
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


@contextlib.contextmanager
def checking_kernels(checked: dict):
    """K1 (the encoder's flash_sdpa) and K5 (the decoder's cached_attention)
    wrapped so that the first call of every shape they are given is held to
    its plain version on the path's own inputs (K5 at n_past 0 and after),
    each result in ``checked`` under its shape; restored on exit."""
    from whisper_tpu_torch.model import encoder as encoder_module
    real_k1, real_k5 = encoder_module.flash_sdpa, decoder_module.cached_attention

    def k1_spy(q, k, v, causal=False):
        out = real_k1(q, k, v, causal)
        key = ("K1", *q.shape, k.shape[-2])
        if key not in checked:
            checked[key] = _within(out, flash_attention_reference(q, k, v, causal),
                                   K1_TOL[q.dtype])
        return out

    def k5_spy(q, k, v, n_past):
        out = real_k5(q, k, v, n_past)
        key = ("K5", *q.shape, k.shape[-1], "n_past per row" if isinstance(n_past, torch.Tensor)
               else "n_past 0" if n_past == 0 else "n_past > 0")
        if key not in checked:
            checked[key] = _within(out, cached_attention_reference(q, k, v, n_past),
                                   K5_TOL[q.dtype])
        return out

    encoder_module.flash_sdpa, decoder_module.cached_attention = k1_spy, k5_spy
    try:
        yield
    finally:
        encoder_module.flash_sdpa, decoder_module.cached_attention = real_k1, real_k5


def check_path_shapes(tag: str, path: str, checked: dict) -> None:
    """Log what checking_kernels found and fail unless every shape held."""
    for key, (ok, err) in sorted(checked.items(), key=str):
        log(f"[{tag}]   {key[0]} at q {tuple(key[1:5])} over {key[5]} keys"
            f"{f', {key[6]}' if len(key) > 6 else ''}: max_abs_err {err:.3e} against "
            f"its plain version: {'within' if ok else 'OUTSIDE'} "
            f"{'K1_TOL' if key[0] == 'K1' else 'K5_TOL'}")
    if not checked or not all(ok for ok, _ in checked.values()):
        raise AssertionError(f"K1 or K5 disagrees with its plain version at a shape of {path}")


WF_SECONDS = 64  # phase 17's clip: two full windows and a short last one (PERF.md §4)
WF_WORD_TICK = 0.02  # phase 16: word times CPU vs card within one timestamp tick


def _wav_clip(seconds: int, seed: int):
    """A synthetic clip written as a 16-bit WAV under build/ and read back
    through the port's load_wav: (path, the samples as read)."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / f"clip-{seconds}s-seed{seed}.wav"
    write_wav(str(path), synthetic_audio(SAMPLE_RATE * seconds, seed=seed))
    return str(path), load_wav(str(path))


def _same_transcript(name: str, cpu: dict, card: dict) -> None:
    """Text, language and every segment's tokens, seek, t0 and t1 identical
    on the two devices; word times within WF_WORD_TICK."""
    segs = list(zip(cpu["segments"], card["segments"]))
    if len(cpu["segments"]) != len(card["segments"]):
        raise AssertionError(f"whisper_full {name}: {len(cpu['segments'])} segments on cpu, "
                             f"{len(card['segments'])} on cuda")
    for i, (c, g) in enumerate(segs):
        for key in ("seek", "t0", "t1", "tokens"):
            if c[key] != g[key]:
                extra = (f", parting at token {_first_divergence(c[key], g[key])}"
                         if key == "tokens" else f": {c[key]} vs {g[key]}")
                raise AssertionError(f"whisper_full {name}: segment {i}'s {key} differs "
                                     f"between cpu and cuda{extra}")
        cw, gw = c["words"] or [], g["words"] or []
        if [w["word"] for w in cw] != [w["word"] for w in gw] or any(
                abs(a[k] - b[k]) > WF_WORD_TICK + 1e-9 for a, b in zip(cw, gw)
                for k in ("start", "end")):
            raise AssertionError(f"whisper_full {name}: segment {i}'s words differ")
    if cpu["text"] != card["text"] or cpu["language"] != card["language"]:
        raise AssertionError(f"whisper_full {name}: text or language differs")


def phase_whisper_full_parity(card: str) -> None:
    """transcribe on phase 4's f32 checkpoint, a 35 s WAV, CPU (plain
    versions) vs card (kernels): greedy with word timestamps (each
    device's default loop), then beam 3 by the device beam and beam 3 with
    patience by the host loop's device top-k step (use_device_loop on both)."""
    cfg, path = tiny_checkpoint()
    models = {dev: load_model(str(path), device=dev, dtype=torch.float32)
              for dev in ("cpu", "cuda")}
    wav_path, audio = _wav_clip(35, seed=35)
    runs = [("greedy", dict(word_timestamps=True), None),
            ("beam3", dict(beam_size=3), "k7"),
            ("beam3-patience", dict(beam_size=3, patience=1.0), "k6")]
    for name, fields, kernel in runs:
        opts = TranscribeOptions(temperature=0.0, **fields)
        if kernel is not None:
            opts = dataclasses.replace(opts, use_device_loop=True)
        out = {}
        for dev, m in models.items():  # the card last: its launches are read
            m.timers.counts.clear()
            _zero_launches()
            out[dev] = transcribe(m, wav_path if dev == "cuda" else audio, opts)
            n = _read_launches()
        _same_transcript(name, out["cpu"], out["cuda"])
        windows = models["cuda"].timers.counts["encode"]
        n_tok = sum(len(s["tokens"]) for s in out["cuda"]["segments"])
        n_words = sum(len(s["words"] or []) for s in out["cuda"]["segments"])
        log(f"[wf-parity] {name}: 35 s WAV, {windows} windows, {len(out['cuda']['segments'])} "
            f"segments, {n_tok} tokens, {n_words} words: identical on cpu and cuda (words "
            f"within {WF_WORD_TICK} s); launches on cuda {n}; {card}")
        if n["k1_f32"] != cfg.n_audio_layer * windows or not n["k5"] or (
                kernel and not n[kernel]):
            raise AssertionError(f"whisper_full {name}: a kernel of the path was not launched "
                                 f"as expected on the card: {n}")


def phase_whisper_full(card: str, model) -> dict:
    """transcribe on phase 5's large-v3 bf16 model: a WF_SECONDS WAV with
    language ID, the ladder (0.0, 0.4) with best_of 2, word timestamps and
    audio_ctx "auto", twice; the second run timed. Returns its launches."""
    cfg = model.config
    wav_path, _ = _wav_clip(WF_SECONDS, seed=64)
    opts = TranscribeOptions(language=None, temperature=(0.0, 0.4), best_of=WF_BEST_OF,
                             word_timestamps=True, audio_ctx="auto")
    # Light spies (each hands on to the real function): the ladder's rungs,
    # the encoder calls and the decoder forwards (every forward, decode_step
    # or cross_attention_probs, embeds its tokens once). Run 1 also holds K1
    # and K5 to their plain versions on the path's own inputs
    # (checking_kernels).
    from whisper_tpu_torch.model import encoder as encoder_module
    from whisper_tpu_torch.pipeline import transcribe as transcribe_module
    real = (transcribe_module.decode_full, encoder_module.encode, decoder_module._embed)
    rungs, frames, forwards, checked = [], [], [0], {}

    def decode_spy(decoder, vocab, cross_k, cross_v, options, **kw):
        rungs.append(options.temperature)
        return real[0](decoder, vocab, cross_k, cross_v, options, **kw)

    def encode_spy(encoder, mel, **kw):
        frames.append(mel.shape[-1])
        return real[1](encoder, mel, **kw)

    def embed_spy(*args):
        forwards[0] += 1
        return real[2](*args)

    for run in (1, 2):
        model.timers.totals.clear()
        model.timers.counts.clear()
        rungs.clear()
        frames.clear()
        forwards[0] = 0
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        transcribe_module.decode_full, encoder_module.encode, decoder_module._embed = (
            decode_spy, encode_spy, embed_spy)
        try:
            with checking_kernels(checked) if run == 1 else contextlib.nullcontext():
                t0 = time.perf_counter()
                res = transcribe(model, wav_path, opts)
                wall = time.perf_counter() - t0
        finally:
            transcribe_module.decode_full, encoder_module.encode, decoder_module._embed = real
        n = _read_launches()
        tm = model.timers.totals
        segs = res["segments"]
        windows = len(frames)
        per_window = []  # each window's rungs, from the cross memory's length
        for t in rungs:
            if not per_window or t == opts.temperature[0]:
                per_window.append([])
            per_window[-1].append(t)
        stages = ", ".join(f"{k} {tm.get(k, 0.0) * 1e3:.1f} ms"
                           for k in ("mel", "lang_id", "encode", "decode", "word_align"))
        log(f"[wf-main] run {run}: large-v3 bf16, {res['duration']:.1f} s WAV, language "
            f"{res['language']!r} detected, temperature (0.0, 0.4), best_of {WF_BEST_OF}, word "
            f"timestamps, audio_ctx auto: {windows} windows decoded (mel frames {frames}), "
            f"rungs per window {per_window}; {stages}; total {wall * 1e3:.1f} ms, "
            f"{res['duration'] / wall:.3f} s of audio per wall second; {len(segs)} segments, "
            f"{sum(len(s['tokens']) for s in segs)} tokens, "
            f"{sum(len(s['words'] or []) for s in segs)} words; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {forwards[0]} decoder "
            f"forwards; launches {n}; {card}")
        if run == 1:
            check_path_shapes("wf-main", "the whisper_full path", checked)
        if not (windows >= 3 and len(per_window) == windows
                and all(f == 3000 or f % 512 == 0 for f in frames)):
            raise AssertionError(f"windows: mel frames {frames}, rungs {per_window}")
        if any(w not in ([0.0], [0.0, 0.4]) for w in per_window) or [0.0, 0.4] not in per_window:
            raise AssertionError(f"the ladder's rungs {per_window}: no rung at t > 0")
        if n["k1"] != cfg.n_audio_layer * windows:
            raise AssertionError(f"flash_attention launched {n['k1']} times for {windows} "
                                 f"encoded windows, not {cfg.n_audio_layer} per window")
        if n["k5"] != cfg.n_text_layer * forwards[0]:
            raise AssertionError(f"cached_attention launched {n['k5']} times over "
                                 f"{forwards[0]} decoder forwards, not {cfg.n_text_layer} each")
        if res["language"] not in model.vocab.languages or not segs or not any(
                s["words"] for s in segs):
            raise AssertionError(f"bad result: language {res['language']}, {len(segs)} segments")
        for s in segs:
            if not (all(0 <= t < cfg.n_vocab for t in s["tokens"]) and math.isfinite(
                    s["avg_logprob"]) and 0.0 <= s["t0"] <= s["t1"] <= res["duration"] + 30):
                raise AssertionError(f"bad segment {s}")
    log(f"[wf-main] segment 0: {segs[0]['tokens'][:12]}... t0 {segs[0]['t0']} t1 "
        f"{segs[0]['t1']}, temperature {segs[0]['temperature']}")
    return n


K1C_CASES = [  # (batch·heads, tq, tk, causal, dtype): the training path at batch 2
    (2 * 20, 1500, 1500, False, torch.float32),   # large-v3 encoder self-attention, f32
    (2 * 20, 63, 63, True, torch.float32),        # its decoder over a 64-token bucket
    (2 * 20, 1500, 1500, False, torch.bfloat16),
    # phase 20's tone-word fine-tune at batch 16, one head: the encoder over
    # n_audio_ctx 64 and the decoder over a 32-token bucket (phase 20 fails
    # if it gives flash_sdpa a shape that is not listed here)
    (16, 64, 64, False, torch.float32),
    (16, 31, 31, True, torch.float32),
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


# ---- phases 18-20: the bench, chunked/streaming/CLI, the tone-word round trip ----

BENCH_SECONDS = 15  # phase 18: each bench run's budget (bench.py's BENCH_SECONDS)
BENCH_RUNS = [("greedy-b64", {}), ("beam5-b48", {"BENCH_BEAM": "5"})]  # bench.py's batches
def task_ctx(sample_len: int) -> int:
    """Self-cache positions of decode_full's device loop (decoding/task.py):
    the 32-token prompt bucket, the sample length and 8 spare."""
    return 32 + sample_len + 8


def guarded(cfg: WhisperConfig) -> list:
    """Every serving configuration the smoke runs on large-v3, as the guard
    sees it, from the constants the phases run with: (phase, streams, beam,
    self-cache positions, KV bytes per element). The host beam (phase 12)
    and whisper_full (phase 17) keep a cache of n_text_ctx positions."""
    out = [("5", MAIN_STREAMS, 1, task_ctx(MAIN_SAMPLE_LEN), 2),
           ("8", INT8_BATCH, 1, serving_ctx(cfg, INT8_TOKENS), 1),
           ("11", BEAM_GROUPS, BEAM, serving_ctx(cfg, INT8_TOKENS), 1),
           ("12", HOST_BEAM_STREAMS, BEAM, cfg.n_text_ctx, 2),
           ("17", WF_BEST_OF, 1, cfg.n_text_ctx, 2),
           ("19", CHUNK_WINDOWS, 1, task_ctx(cfg.n_text_ctx // 2), 2)]
    for name, knobs in BENCH_RUNS:  # as run_benchmark reads them
        kw = bench_config_from_env(knobs)
        out.append((f"18 {name}", kw["batch"], kw["beam_size"] or 1, serving_ctx(cfg, 64),
                    1 if kw["kv_dtype"] == "int8" else 2))
    return out


def guard_reading(tag: str, batch: int, beam: int, ctx: int, kv_bytes: int) -> dict:
    """The guard's estimate for a large-v3 configuration beside this
    process's peaks since the last reset. Phases 8 and 11 hold phase 5's
    bf16 model as well, so their readings are not the guard's calibration
    (config.PEAK_OVER_ESTIMATE comes from phase 18's processes, which hold
    only the guarded model)."""
    est = check_serving_hbm(PRESETS["large-v3"], batch, beam=beam, ctx=ctx,
                            kv_dtype_bytes=kv_bytes, what=tag, device="cuda")
    alloc, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    log(f"[{tag}] memory guard: estimate {est['total'] / 1e9:.3f} GB (budget "
        f"{est['budget'] / 1e9:.3f} GB, {CARD_MEMORY_FRACTION:.4f} of the card); peak allocated "
        f"{alloc / 1e9:.3f} GB, reserved {reserved / 1e9:.3f} GB (reserved / estimate "
        f"{reserved / est['total']:.3f}, phase 5's bf16 model included)")
    return est


def phase_bench(card: str) -> dict:
    """python -m whisper_tpu_torch.utils.benchmark twice in a subprocess
    each: large-v3 int8 greedy at b64 and beam 5 at b48. Returns each run's
    launches over its timed steps."""
    cfg = PRESETS["large-v3"]
    for name, batch, beam, ctx, kv in guarded(cfg):
        est = check_serving_hbm(cfg, batch, beam=beam, ctx=ctx, kv_dtype_bytes=kv,
                                what=f"phase {name}", device="cuda")
        log(f"[bench] the guard admits phase {name} (batch {batch}, beam {beam}, ctx {ctx}, "
            f"kv {kv} B): estimate {est['total'] / 1e9:.3f} GB of {est['budget'] / 1e9:.3f} GB")
    launches = {}
    for name, knobs in BENCH_RUNS:
        env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
        env.update(BENCH_SECONDS=str(BENCH_SECONDS), **knobs)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.utils.benchmark"],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        out = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or len(out) != 1:
            raise AssertionError(f"bench {name}: exit {proc.returncode}, stdout {out}, stderr "
                                 f"{proc.stderr[-3000:]}")
        print(out[0], flush=True)
        line = json.loads(out[0])
        d = line["detail"]
        n = d["kernel_launches"]
        est = d["hbm_estimate"]
        alloc, reserved = d["peak_allocated_bytes"], d["peak_reserved_bytes"]
        log(f"[bench] {name}: {line['metric']} = {line['value']:.3f} {line['unit']} ({d['iters']} "
            f"steps in {d['wall_s']:.3f} s after a {d['warmup_s']:.3f} s warm-up; stages "
            f"{ {k: round(v, 4) for k, v in d['stages_s'].items()} } s; {wall:.1f} s for the "
            f"process); memory guard: estimate {est['total'] / 1e9:.3f} GB (budget "
            f"{est['budget'] / 1e9:.3f} GB), peak allocated {alloc / 1e9:.3f} GB, reserved "
            f"{reserved / 1e9:.3f} GB (reserved / estimate {reserved / est['total']:.3f}); "
            f"launches over the timed steps {n}; {d['nvidia_smi']}")
        expect = ("k1", "act", "ln", "gelu", "k4", "k4_self") + (("k7",) if knobs else ())
        if not (line["metric"].startswith("rtf_torch_large-v3_b") and line["value"] > 0
                and line["vs_baseline"] is None and d["iters"] >= 1 and d["nvidia_smi"]
                and d["device"].startswith("cuda") and d["torch"] == torch.__version__):
            raise AssertionError(f"bench {name}: bad line {line}")
        if any(n[k] < d["iters"] for k in expect):
            raise AssertionError(f"bench {name}: a kernel of the serving step was not launched "
                                 f"every step: {n} over {d['iters']} steps")
        if reserved > PEAK_OVER_ESTIMATE * est["total"]:
            raise AssertionError(f"bench {name}: peak reserved {reserved} bytes, more than "
                                 f"PEAK_OVER_ESTIMATE ({PEAK_OVER_ESTIMATE}) times the guard's "
                                 f"estimate {est['total']}: the guard's calibration no longer "
                                 f"holds")
        launches[name] = n
    return launches


CHUNK_WINDOWS = 3  # phase 19: WF_SECONDS of audio in 30 s windows, one batch


def _cli_json(device: str, ckpt: Path, wav: str) -> dict:
    """python -m whisper_tpu_torch.cli transcribe ... --output-json on
    ``device``: the file's result for ``wav``."""
    out = CKPT_DIR / f"cli-transcribe-{device}.json"
    proc = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.cli", "transcribe",
                           str(ckpt), wav, "--temperature", "0", "--output-json", str(out),
                           "--device", device], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"cli transcribe on {device}: exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f)[wav]


def phase_chunked_streaming_cli(card: str, model) -> dict:
    """Phase 4's f32 checkpoint through transcribe_chunked (with and without
    overlap), StreamingTranscriber (5 s feeds) and the CLI's transcribe
    --output-json on the CPU and on the card: identical transcripts. Then
    phase 5's large-v3 bf16 model runs transcribe_chunked on phase 17's WAV
    twice, the first run holding K1 and K5 to their plain versions at every
    shape it gives them. Returns the second run's launches."""
    cfg, path = tiny_checkpoint()
    models = {dev: load_model(str(path), device=dev, dtype=torch.float32)
              for dev in ("cpu", "cuda")}
    wav_path, audio = _wav_clip(35, seed=35)
    opts = TranscribeOptions(condition_on_previous_text=False, temperature=0.0)
    for name, overlap in (("chunked", 0.0), ("chunked-overlap-5s", 5.0)):
        out = {}
        for dev, m in models.items():  # the card last: its launches are read
            _zero_launches()
            out[dev] = transcribe_chunked(m, wav_path if dev == "cuda" else audio, opts,
                                          overlap_seconds=overlap)
            n = _read_launches()
        _same_transcript(name, out["cpu"], out["cuda"])
        log(f"[chunked] {name}: 35 s WAV, {len({s['seek'] for s in out['cuda']['segments']})} "
            f"windows in one batch, {len(out['cuda']['segments'])} segments, "
            f"{sum(len(s['tokens']) for s in out['cuda']['segments'])} tokens: identical on cpu "
            f"and cuda; launches on cuda {n}; {card}")
        if n["k1_f32"] != cfg.n_audio_layer or not n["k5"] or n["k5"] % cfg.n_text_layer:
            raise AssertionError(f"chunked {name}: K1 not once per encoder layer for the one "
                                 f"batch, or K5 not n_text_layer times a forward: {n}")
    final, committed = {}, {}
    for dev, m in models.items():
        _zero_launches()
        st = StreamingTranscriber(m, TranscribeOptions(temperature=0.0))
        committed[dev] = []
        for start in range(0, len(audio), 5 * SAMPLE_RATE):
            committed[dev] += st.feed(audio[start: start + 5 * SAMPLE_RATE])["committed"]
        final[dev] = st.finalize()
        n = _read_launches()
    _same_transcript("streaming", final["cpu"], final["cuda"])
    if [c["tokens"] for c in committed["cpu"]] != [c["tokens"] for c in committed["cuda"]] or \
            not committed["cuda"]:
        raise AssertionError("streaming: the committed segments differ between cpu and cuda")
    offline = transcribe(models["cuda"], audio, TranscribeOptions(temperature=0.0))
    _same_transcript("streaming vs offline on cuda", offline, final["cuda"])
    log(f"[streaming] 35 s in 5 s feeds: {len(committed['cuda'])} segments committed while "
        f"feeding, {len(final['cuda']['segments'])} in the final transcript, identical on cpu "
        f"and cuda and equal to offline transcribe; launches on cuda {n}; {card}")
    if not (n["k1_f32"] and n["k5"]):
        raise AssertionError(f"streaming: K1 or K5 not launched on the card: {n}")
    cli = {dev: _cli_json(dev, path, wav_path) for dev in ("cpu", "cuda")}
    _same_transcript("cli transcribe", cli["cpu"], cli["cuda"])
    log(f"[cli] python -m whisper_tpu_torch.cli transcribe --output-json --device cpu|cuda: "
        f"{len(cli['cuda']['segments'])} segments, identical; {card}")
    del models

    wf_path, _ = _wav_clip(WF_SECONDS, seed=64)
    cfg = model.config
    checked, n = {}, {}
    for run in (1, 2):
        model.timers.totals.clear()
        model.timers.counts.clear()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        with checking_kernels(checked) if run == 1 else contextlib.nullcontext():
            t0 = time.perf_counter()
            res = transcribe_chunked(model, wf_path)
            wall = time.perf_counter() - t0
        n = _read_launches()
        tm = model.timers.totals
        segs = res["segments"]
        stages = ", ".join(f"{k} {tm.get(k, 0.0) * 1e3:.1f} ms" for k in ("mel", "encode",
                                                                           "decode"))
        log(f"[chunked-main] run {run}: large-v3 bf16, {res['duration']:.1f} s WAV in "
            f"{model.timers.counts.get('encode', 0)} batch of {CHUNK_WINDOWS} windows, language "
            f"{res['language']!r} detected, greedy t = 0 in lockstep on the device loop: "
            f"{stages}; total {wall * 1e3:.1f} ms, {res['duration'] / wall:.3f} s of audio per "
            f"wall second; {len(segs)} segments, {sum(len(s['tokens']) for s in segs)} tokens; "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {n}; {card}")
        if run == 1:
            check_path_shapes("chunked-main", "the chunked path", checked)
        if n["k1"] != cfg.n_audio_layer or not n["k5"] or n["k5"] % cfg.n_text_layer:
            raise AssertionError(f"chunked large-v3: K1 not once per encoder layer for the "
                                 f"one batch, or K5 not n_text_layer times a forward: {n}")
        if len({s["seek"] for s in segs}) > CHUNK_WINDOWS or not segs or \
                res["language"] not in model.vocab.languages:
            raise AssertionError(f"chunked large-v3: bad result, {len(segs)} segments")
        for s in segs:
            if not (all(0 <= t < cfg.n_vocab for t in s["tokens"]) and math.isfinite(
                    s["avg_logprob"]) and 0.0 <= s["t0"] <= s["t1"] <= res["duration"] + 30):
                raise AssertionError(f"bad segment {s}")
    shapes = {key[1] for key in checked if key[0] == "K1"}
    if shapes != {CHUNK_WINDOWS}:
        raise AssertionError(f"chunked large-v3 encoded batches of {shapes} windows, not "
                             f"{CHUNK_WINDOWS}")
    _load_times(card)
    return n


def _load_times(card: str) -> None:
    """load_model of phase 5's large-v3 GGML in bf16 on the card with the
    native reader and with the Python one, in turns (native, Python, Python,
    native; the file in the page cache since phase 5), each read asserted."""
    walls = {"ggml-native": [], "ggml-python": []}
    for kind in ("ggml-native", "ggml-python", "ggml-python", "ggml-native"):
        before = native.reads.get(kind, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = load_model(str(LARGE_V3_CKPT), dtype=torch.bfloat16, device="cuda",
                       use_native=kind == "ggml-native")
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
        if native.reads.get(kind, 0) != before + 1:
            raise AssertionError(f"load_model did not read through {kind}: {native.reads}")
        del m
        torch.cuda.empty_cache()
    nat, py = (sum(walls[k]) / 2 for k in ("ggml-native", "ggml-python"))
    log(f"[load] load_model large-v3 ({LARGE_V3_CKPT.stat().st_size / 1e9:.2f} GB f16) in bf16 "
        f"on the card: native reader {nat:.3f} s ({walls['ggml-native'][0]:.3f}, "
        f"{walls['ggml-native'][1]:.3f}), Python reader {py:.3f} s ({walls['ggml-python'][0]:.3f}, "
        f"{walls['ggml-python'][1]:.3f}); native / Python {nat / py:.3f}; {card}")


# Phase 20: tests/test_wer_roundtrip.py's tone-word round trip. Its config
# has d_head 32 (state 64, 2 heads); K1, K4 and K5 take d_head 64 only (every
# Whisper size), so on the card the same config runs with one head.
RT_STEPS, RT_BATCH = 700, 16
RT_TRAIN, RT_HELD_OUT = 96, 8
RT_MAX_WER = 0.6  # the JAX test's own bound


def _roundtrip_config() -> WhisperConfig:
    return WhisperConfig(n_vocab=51864, n_audio_ctx=64, n_audio_state=64, n_audio_head=1,
                         n_audio_layer=2, n_text_ctx=96, n_text_state=64, n_text_head=1,
                         n_text_layer=2, n_mels=80, f16=0)


def phase_roundtrip(card: str) -> dict:
    """Train the micro config from scratch on tone words on the card, write
    it as GGML, reload it through the native reader and score held-out WAVs
    with ``cli eval`` (WER < RT_MAX_WER); then the same held-out WAVs with
    int8 decoder weights. Returns the training's launches."""
    cfg = _roundtrip_config()
    n_vocab = cfg.n_vocab
    rng = np.random.default_rng(0)
    train = [synth.make_pair(rng) for _ in range(RT_TRAIN)]
    held_out = [synth.make_pair(rng) for _ in range(RT_HELD_OUT)]
    model = random_model(cfg, seed=0, device="cuda", on_device=False)
    model = dataclasses.replace(model, vocab=make_vocab(n_vocab, synth.word_tokens(n_vocab),
                                                        n_vocab))
    for _, text in train[:4]:
        if model.vocab.decode(model.vocab.encode(" " + text)).strip() != text:
            raise AssertionError(f"the tone-word vocab does not round-trip {text!r}")
    # A light spy on flash_sdpa (it hands on to the real one and launches
    # nothing itself) records the shapes the fine-tune gives K1c: each must
    # be a K1C_CASES shape, held to autograd of the plain version there.
    from whisper_tpu_torch.model import encoder as encoder_module
    from whisper_tpu_torch.training import train as train_module
    real_sdpa, sdpa_shapes = train_module.flash_sdpa, set()

    def sdpa_spy(q, k, v, causal=False):
        sdpa_shapes.add((q.shape[:-2].numel(), q.shape[-2], k.shape[-2], causal, q.dtype))
        return real_sdpa(q, k, v, causal)

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    encoder_module.flash_sdpa = train_module.flash_sdpa = sdpa_spy
    try:
        t0 = time.perf_counter()
        state = finetune_module.finetune(model, train, steps=RT_STEPS, batch_size=RT_BATCH,
                                         lr=1e-3, warmup=20, log_every=RT_STEPS, seed=0)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        encoder_module.flash_sdpa = train_module.flash_sdpa = real_sdpa
    n = _read_launches()
    unheld = sdpa_shapes - set(K1C_CASES)
    log(f"[roundtrip] flash_sdpa shapes of the fine-tune (batch·heads, tq, tk, causal, dtype): "
        f"{sorted(sdpa_shapes, key=str)}, each held in phase 13's K1C_CASES")
    if unheld or not sdpa_shapes:
        raise AssertionError(f"the fine-tune gave flash_sdpa shapes that K1C_CASES does not "
                             f"hold to the plain version: {unheld}")
    loss = finetune_module.evaluate(model, state.params, train[:RT_BATCH], RT_BATCH, "en")
    per_step = cfg.n_audio_layer + cfg.n_text_layer
    log(f"[roundtrip] tone words, d_head 64 (state 64, one head: K1/K4/K5 take d_head 64 "
        f"only; the JAX test's two heads are d_head 32), {cfg.n_audio_layer} + "
        f"{cfg.n_text_layer} layers, f32: finetune {RT_STEPS} steps at batch {RT_BATCH} on "
        f"{RT_TRAIN} pairs in {train_s:.1f} s ({train_s / RT_STEPS * 1e3:.2f} ms a step, "
        f"batches and mel included), teacher-forced loss {loss:.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches {n}; {card}")
    if n["k1_f32"] != RT_STEPS * per_step or n["k1c_bwd"] != RT_STEPS * per_step or n["k1"]:
        raise AssertionError(f"finetune did not run K1's f32 kernel and the K1c backward "
                             f"kernel once per attention layer a step: {n}")

    rt_dir = CKPT_DIR / "roundtrip"
    data = rt_dir / "held-out"
    data.mkdir(parents=True, exist_ok=True)
    ckpt = rt_dir / "tone-words-f32.bin"
    write_ggml(str(ckpt), cfg, model.filters.cpu().numpy(), synth.word_tokens(n_vocab),
               params_to_ggml(state.params, cfg))
    del model, state
    before = dict(native.reads)
    reloaded = load_model(str(ckpt), device="cuda", dtype=torch.float32, use_native=True)
    if native.reads.get("ggml-native", 0) != before.get("ggml-native", 0) + 1:
        raise AssertionError(f"the checkpoint was not read by the native reader: {native.reads}")
    wavs = []
    for i, (audio, text) in enumerate(held_out):
        wavs.append(str(data / f"utt{i}.wav"))
        write_wav(wavs[-1], audio)
        (data / f"utt{i}.txt").write_text(text + "\n")

    proc = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.cli", "eval", str(ckpt),
                           str(data), "--dtype", "float32", "--language", "en",
                           "--without-timestamps", "--device", "cuda"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0 or "native reader" not in proc.stderr:
        raise AssertionError(f"cli eval: exit {proc.returncode}, the native reader not "
                             f"logged: {proc.stderr[-3000:]}")
    cli_eval = json.loads(proc.stdout)
    log(f"[roundtrip] python -m whisper_tpu_torch.cli eval (native reader): {cli_eval}")
    if not (cli_eval["wer"] < RT_MAX_WER and cli_eval["utterances"] == RT_HELD_OUT):
        raise AssertionError(f"tone-word WER {cli_eval['wer']} not below {RT_MAX_WER}")

    int8 = reloaded.with_params(quantize_decoder_weights(reloaded.params))
    opts = TranscribeOptions(language="en", without_timestamps=True)
    # K1 and K5 held to their plain versions at the first call of every
    # shape this decode gives them (checking_kernels), which is cli eval's
    runs, checked = {}, {}
    for name, m in (("f32", reloaded), ("int8 decoder weights", int8)):
        wav_reads = native.reads.get("wav-native", 0)
        with checking_kernels(checked):
            runs[name] = [transcribe(m, w, opts) for w in wavs]
        if native.reads.get("wav-native", 0) != wav_reads + len(wavs):
            raise AssertionError("the held-out WAVs were not read by the native reader")
    check_path_shapes("roundtrip", "the tone-word decode", checked)
    refs = [text for _, text in held_out]
    def tokens(result: dict) -> list:
        return [t for s in result["segments"] for t in s["tokens"]]

    same = sum(tokens(a) == tokens(b) for a, b in zip(runs["f32"], runs["int8 decoder weights"]))
    for name, results in runs.items():
        score = wer(refs, [r["text"] for r in results])
        log(f"[roundtrip] {name}: WER {score['wer']:.4f} over {score['words']} words "
            f"({score['substitutions']} substitutions, {score['deletions']} deletions, "
            f"{score['insertions']} insertions); hypotheses "
            f"{[r['text'].strip() for r in results]}; references {refs}; {card}")
    log(f"[roundtrip] int8 decoder weights: {same} of {len(wavs)} held-out utterances "
        f"({same / len(wavs):.3f}) decode to the f32 run's tokens")
    return n


ENGINE_PARITY_SECONDS = (3, 5, 7, 9, 11)  # phase 21: five streams on 2 slots
ENGINE_BENCH_SECONDS = 20  # phase 23: the engine bench's budget (bench.py's BENCH_SECONDS)


def _engine_reference(eng, audio) -> list:
    """One stream alone through the device loop (decode_segment_device) on
    the engine's own model, with its cache kind, context, prompt and rule
    masks: the tokens the engine must give that stream."""
    model = eng.model
    with torch.inference_mode():
        a = torch.from_numpy(np.asarray(audio, np.float32)).to(eng.device)
        mel = log_mel_spectrogram(a, model.filters, frame_count(len(audio)))
        enc = encode(model.encoder, mel_window(mel, 0, 2 * model.config.n_audio_ctx)[None],
                     quantize_kv=eng.quantize)
        cache = eng._fresh_cache(1, getattr(enc.cross_k, "data", enc.cross_k).dtype)
        toks, lengths, _, _ = decode_segment_device(
            model.decoder, eng._padded_init, eng.init_len, eng.sot_index, cache, enc.cross_k,
            enc.cross_v, eng.sup_mask, eng.blank_mask, sample_len=eng.max_new,
            use_timestamps=not eng.options.without_timestamps,
            max_initial_index=eng.max_initial_index)
    return toks[0, : int(lengths[0])].tolist()


def _same_segments(name: str, want: dict, got: dict) -> None:
    """Text, language, duration and every segment's tokens, seek, t0 and t1
    identical."""
    if (got["text"], got["language"], got["duration"]) != (
            want["text"], want["language"], want["duration"]) or len(got["segments"]) != len(
            want["segments"]):
        raise AssertionError(f"{name}: text, language, duration or segment count differ")
    for i, (w, g) in enumerate(zip(want["segments"], got["segments"])):
        if any(w[k] != g[k] for k in ("seek", "t0", "t1", "tokens")):
            raise AssertionError(f"{name}: segment {i} differs: {w} vs {g}")


@contextlib.contextmanager
def host_waits(on: bool):
    """Under ``on``, torch.cuda.set_sync_debug_mode("warn") for the block:
    yields a list that fills, on exit, with the file:line of every
    synchronizing CUDA call the block made (a blocking copy, .item(), a
    stream synchronize; not a CUDA event's synchronize). PyTorch calls the
    mode a prototype that does not see every synchronizing operation."""
    found: list = []
    if not on:
        yield found
        return
    seen = set()

    def where(filename, lineno) -> str:
        return f"{Path(filename).parent.name}/{Path(filename).name}:{lineno}"

    def record(message, category, filename, lineno, file=None, line=None):
        # set_sync_debug_mode's own notice ("a prototype feature") is not one
        if "called a synchronizing CUDA operation" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if f.filename.startswith(str(ROOT)) and f.filename != filename]
            at = where(filename, lineno)
            if ours:
                at += f" under {where(ours[-1].filename, ours[-1].lineno)}"
            seen.add(at)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode("default")
    found.extend(sorted(seen))


def _graph_steps(tag: str, stats: dict) -> int:
    """Check that the engine on the card replayed its step graph at every
    step but the eager one before each capture; returns the decode steps."""
    steps, graphed, captures = (stats["decode_steps"], stats.get("graph_steps", 0),
                                stats.get("graph_captures", 0))
    if not (graphed > 0 and captures >= 1 and graphed == steps - captures):
        raise AssertionError(f"{tag}: {graphed} of {steps} decode steps replayed a graph after "
                             f"{captures} captures: every step but one a capture must be a "
                             f"replay")
    return steps


def phase_engine_parity(card: str) -> None:
    """The SlotEngine on phase 4's tiny f32 checkpoint, on the CPU and on the
    card: five streams of different lengths on 2 slots (slots reused, a
    partial bucket) under all four schedules, float and int8 (int8 decoder
    weights and int8 pools: K4 at both sites), each stream's tokens the
    device loop's on that device; on the card every decode step after the
    capture of the engine's step graph is its replay, and the ragged
    kernel (K4's self or K5) runs once a layer a step; then
    transcribe_streams over a 35 s and an 8 s clip gives
    pipeline.transcribe's segments."""
    cfg, path = tiny_checkpoint()
    audios = [synthetic_audio(SAMPLE_RATE * sec, seed=40 + sec) for sec in ENGINE_PARITY_SECONDS]
    opts = DecodingOptions(sample_len=24)
    tokens = {}
    for dev in ("cpu", "cuda"):
        base = load_model(str(path), device=dev, dtype=torch.float32)
        for quantize in (False, True):
            model = (base.with_params(quantize_decoder_weights(base.params)) if quantize
                     else base)
            mode = "int8" if quantize else "float"
            ref = None
            steps = 0  # the engines' decode steps on the card
            _zero_launches()
            for sched in SCHEDULES:
                eng = SlotEngine(model, n_slots=2, options=opts, chunk_steps=4,
                                 quantize=quantize, schedule=sched)
                watch = dev == "cuda" and sched == "overlapped"
                eng.spans.record(watch)  # the stages' record must not wait either
                t0 = time.perf_counter()
                with host_waits(watch) as waits:
                    got = [r.tokens for r in eng.transcribe_many(audios)]
                wall = time.perf_counter() - t0
                if watch:
                    spans = eng.spans.drain()
                    buckets = [sp for sp in spans if sp.name == "engine.admit.bucket"]
                    held = sum(len(b.ids) for b in buckets)
                    log(f"[engine-parity] {dev} {mode} {sched}: {len(waits)} synchronizing "
                        f"CUDA calls besides the harvest pulls{': ' if waits else ''}"
                        f"{', '.join(waits)}; {len(spans)} spans recorded, {held} windows "
                        f"in {len(buckets)} buckets")
                    if waits:
                        raise AssertionError(f"the overlapped engine waited on the card outside "
                                             f"its harvest pulls at {waits}")
                    if not held == eng.stats["encode_windows"] == len(audios):
                        raise AssertionError(f"the recorded buckets hold {held} windows and "
                                             f"encode_windows reads {eng.stats['encode_windows']}"
                                             f", not one a stream ({len(audios)})")
                if dev == "cuda":
                    steps += _graph_steps(f"engine {mode} {sched}", eng.stats)
                if ref is None:
                    ref = [_engine_reference(eng, a) for a in audios]
                log(f"[engine-parity] {dev} {mode} {sched}: {len(audios)} streams on 2 slots, "
                    f"{sum(map(len, got))} tokens in {wall * 1e3:.1f} ms, stats "
                    f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in eng.stats.items()} }"
                    f": {'equal to' if got == ref else 'NOT EQUAL TO'} the device loop's tokens")
                if got != ref:
                    i = next(i for i, (g, r) in enumerate(zip(got, ref)) if g != r)
                    raise AssertionError(f"engine {dev} {mode} {sched}: stream {i} parts from "
                                         f"the device loop at token "
                                         f"{_first_divergence(got[i], ref[i])}")
            n = _read_launches()
            ragged = n["k4_ragged"] if quantize else n["k5_ragged"]
            if dev == "cuda" and not ragged == cfg.n_text_layer * steps > 0:
                raise AssertionError(f"the {mode} engine on the card launched {ragged} ragged "
                                     f"kernels over {steps} decode steps, not one a layer a step: "
                                     f"{n}")
            tokens[(dev, mode)] = ref
        topts = TranscribeOptions(temperature=0.0, condition_on_previous_text=True)
        longs = [synthetic_audio(SAMPLE_RATE * 35, seed=1), synthetic_audio(SAMPLE_RATE * 8, seed=3)]
        eng = SlotEngine(base, n_slots=2, chunk_steps=8)
        got = eng.transcribe_streams(longs, topts)
        if dev == "cuda":
            _graph_steps("engine streams", eng.stats)
        for i, (g, a) in enumerate(zip(got, longs)):
            _same_segments(f"engine streams {dev} stream {i}", transcribe(base, a, topts), g)
        log(f"[engine-parity] {dev} transcribe_streams: 35 s and 8 s clips, {eng.stats['windows']} "
            f"windows, {sum(len(g['segments']) for g in got)} segments, each the offline "
            f"transcribe's (tokens, seek, t0, t1); {card}")
    for mode in ("float", "int8"):
        same = sum(c == g for c, g in zip(tokens[("cpu", mode)], tokens[("cuda", mode)]))
        log(f"[engine-parity] {mode}: {same} of {len(audios)} streams token-identical on the CPU "
            f"and the card")


def phase_engine_float(card: str, model) -> tuple:
    """The float engine on phase 5's large-v3 bf16 model: transcribe_streams
    with FLOAT_ENGINE_SLOTS slots (bf16 pools; K5 with each slot's n_past in
    device memory) over phase 17's WAV and three cuts of it, language ID on
    each, windows of up to FLOAT_ENGINE_TOKENS tokens at t=0; twice, run 1
    holding K1 and K5 to their plain versions at every shape the path gives
    them. Returns run 2's launches, its streams and its results."""
    cfg = model.config
    _, wav = _wav_clip(WF_SECONDS, seed=64)
    sr = SAMPLE_RATE
    streams = [wav, wav[5 * sr:], wav[: 40 * sr], wav[20 * sr:]]
    seconds = sum(len(a) for a in streams) / sr
    topts = TranscribeOptions(temperature=0.0)
    real_embed, forwards, checked = decoder_module._embed, [0], {}

    def embed_spy(*args):
        forwards[0] += 1
        return real_embed(*args)

    for run in (1, 2):
        eng = SlotEngine(model, n_slots=FLOAT_ENGINE_SLOTS, chunk_steps=32,
                         max_new_tokens=FLOAT_ENGINE_TOKENS)
        torch.cuda.reset_peak_memory_stats()
        forwards[0] = 0
        _zero_launches()
        decoder_module._embed = embed_spy
        try:
            with checking_kernels(checked) if run == 1 else contextlib.nullcontext():
                t0 = time.perf_counter()
                res = eng.transcribe_streams(streams, topts)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            decoder_module._embed = real_embed
        n = _read_launches()
        st = eng.stats
        log(f"[engine-float] run {run}: large-v3 bf16, {len(streams)} streams ({seconds:.1f} s of "
            f"audio), {FLOAT_ENGINE_SLOTS} slots, pool of {eng.pool_ctx} positions, windows of up "
            f"to {FLOAT_ENGINE_TOKENS} tokens at t=0: {wall * 1e3:.1f} ms, {seconds / wall:.3f} s "
            f"of audio per wall second; {st['windows']} windows, {st['rounds']} rounds, admit "
            f"{st['admit_s'] * 1e3:.1f} ms, chunks {st['chunk_s'] * 1e3:.1f} ms, pulls "
            f"{st['pull_s'] * 1e3:.1f} ms; {sum(len(r['segments']) for r in res)} segments, "
            f"languages {[r['language'] for r in res]}; {forwards[0]} decoder forwards; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {n}; {card}")
        if run == 1:
            check_path_shapes("engine-float", "the float engine's path", checked)
        # the decoder's Python runs at a capture and not at a replay
        steps = _graph_steps(f"engine-float run {run}", st)
        ran = forwards[0] - st["graph_captures"] + st["graph_steps"]
        if (n["k1"] == 0 or n["k5_ragged"] != cfg.n_text_layer * steps
                or n["k5"] != cfg.n_text_layer * ran):
            raise AssertionError(f"the float engine's launches {n} over {ran} forwards, "
                                 f"{steps} of them decode steps: K1 must run, K5 "
                                 f"{cfg.n_text_layer} a forward, ragged at each step")
        if st["windows"] < 2 * len(streams) or [r["duration"] for r in res] != [
                len(a) / sr for a in streams]:
            raise AssertionError(f"bad streams: {st['windows']} windows, {res}")
        for r in res:
            if r["language"] not in model.vocab.languages:
                raise AssertionError(f"bad language {r['language']}")
            for seg in r["segments"]:
                if not (all(0 <= t < cfg.n_vocab for t in seg["tokens"])
                        and math.isfinite(seg["avg_logprob"])
                        and 0.0 <= seg["t0"] <= seg["t1"] <= r["duration"] + 30):
                    raise AssertionError(f"bad segment {seg}")
    del eng
    torch.cuda.empty_cache()
    return n, streams, res


def phase_engine_bench(card: str) -> dict:
    """python -m whisper_tpu_torch.utils.benchmark with BENCH_MODE=engine in
    a subprocess: large-v3 int8 at bench.py's greedy engine defaults (64
    slots, 128 streams of 24/27/30 s, chunks of 32, 64 tokens). Returns its
    launches over the timed waves."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_MODE="engine", BENCH_SECONDS=str(ENGINE_BENCH_SECONDS))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.utils.benchmark"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(out) != 1:
        raise AssertionError(f"engine bench: exit {proc.returncode}, stdout {out}, stderr "
                             f"{proc.stderr[-3000:]}")
    print(out[0], flush=True)
    line = json.loads(out[0])
    d = line["detail"]
    n, est = d["kernel_launches"], d["hbm_estimate"]
    alloc, reserved = d["peak_allocated_bytes"], d["peak_reserved_bytes"]
    log(f"[engine-bench] {line['metric']} = {line['value']:.3f} {line['unit']} ({d['waves']} "
        f"waves of {d['n_streams']} streams in {d['wall_s']:.3f} s after a {d['warmup_s']:.3f} s "
        f"warm-up; {d['tokens_last_wave']} tokens in the last wave; its stats "
        f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in d['stats'].items()} }; "
        f"{wall:.1f} s for the process); memory guard: estimate {est['total'] / 1e9:.3f} GB "
        f"(budget {est['budget'] / 1e9:.3f} GB), peak allocated {alloc / 1e9:.3f} GB, reserved "
        f"{reserved / 1e9:.3f} GB (reserved / estimate {reserved / est['total']:.3f}); launches "
        f"over the timed waves {n}; {d['nvidia_smi']}")
    want = f"rtf_torch_large-v3_engine_s{ENGINE_SLOTS}_q{2 * ENGINE_SLOTS}_int8"
    if not (line["metric"] == want and line["value"] > 0 and line["vs_baseline"] is None
            and d["waves"] >= 1 and d["n_results"] == 2 * ENGINE_SLOTS and d["nvidia_smi"]
            and d["device"].startswith("cuda") and d["torch"] == torch.__version__):
        raise AssertionError(f"engine bench: bad line {line}")
    if not (n["k1"] > 0 and n["k4"] > n["k4_self"] > n["k4_ragged"] > 0):
        raise AssertionError(f"engine bench: K1, K4 cross, K4 self at the prefill and the "
                             f"ragged K4 self must each run in the timed waves: {n}")
    steps = _graph_steps("engine bench", d["steps"])
    if n["k4_ragged"] != PRESETS["large-v3"].n_text_layer * steps:
        raise AssertionError(f"engine bench: {n['k4_ragged']} ragged K4 launches over {steps} "
                             f"decode steps, not one a layer a step")
    st = d["stats"]
    if st["staged_buckets"] * ENGINE_BUCKET != 2 * ENGINE_SLOTS:
        raise AssertionError(f"engine bench: {st['staged_buckets']} admission buckets for "
                             f"{2 * ENGINE_SLOTS} streams, not all of {ENGINE_BUCKET}: shapes "
                             f"outside K1_CASES and K4_CASES")
    if reserved > PEAK_OVER_ESTIMATE * est["total"]:
        raise AssertionError(f"engine bench: peak reserved {reserved} bytes, more than "
                             f"PEAK_OVER_ESTIMATE ({PEAK_OVER_ESTIMATE}) times the guard's "
                             f"estimate {est['total']}")
    return n


STEP_GRAPH_SLOTS, STEP_GRAPH_TOKENS = 240, 96  # the benchmark's batch cells' pool and cap
STEP_GRAPH_STEPS = 16  # steps a turn, each turn from the same pool state


def phase_engine_step_graph(card: str) -> dict:
    """The int8 engine's decode step at the benchmark's batch cells' shape
    (large-v3, random weights, int8 decoder weights, STEP_GRAPH_SLOTS slots
    and the trash row, int8 pools, timestamp rules): every slot is filled
    from one prefilled bucket and set at its own step of a window, then the
    step body called eagerly and one replay of its captured graph run in
    turns (eager, graph, graph, eager), STEP_GRAPH_STEPS steps a turn from
    that same state: CUDA events over the turn and the host's wall time to
    enqueue it, a step each; both give the same tokens and positions."""
    cfg = PRESETS["large-v3"]
    model = random_model(cfg, seed=0, dtype=torch.bfloat16, device="cuda", on_device=True)
    model = model.with_params(quantize_decoder_weights(model.params))
    eng = SlotEngine(model, n_slots=STEP_GRAPH_SLOTS, chunk_steps=32,
                     max_new_tokens=STEP_GRAPH_TOKENS, quantize=True)
    eng._prepare_streams(TranscribeOptions(temperature=0.0))
    with torch.inference_mode():
        audio = [synthetic_audio(SAMPLE_RATE * 25, seed=70 + i) for i in range(ENGINE_BUCKET)]
        staged = eng._encode_bucket(eng._window_batch(audio, ENGINE_BUCKET), ENGINE_BUCKET)
        for first in range(0, STEP_GRAPH_SLOTS, ENGINE_BUCKET):
            eng._install_rows(staged, list(range(first, first + ENGINE_BUCKET)),
                              list(range(ENGINE_BUCKET)))
        del staged
        st = eng._state
        gen = case_generator("engine-step-graph")
        # each slot part-way through its window, as in a wave's steady state
        st.step[:-1] = torch.randint(0, STEP_GRAPH_TOKENS - STEP_GRAPH_STEPS - 1,
                                     (STEP_GRAPH_SLOTS,), generator=gen,
                                     device=gen.device).to(st.step)
        st.n_past[:-1] += st.step[:-1]
        fields = [f.name for f in dataclasses.fields(st)
                  if isinstance(getattr(st, f.name), torch.Tensor)]
        start = {name: getattr(st, name).clone() for name in fields}

        def restore():
            for name in fields:
                getattr(st, name).copy_(start[name])

        body = functools.partial(_decode_step, eng.model.decoder, st, eng._cross_pool_k,
                                 eng._cross_pool_v, eng.sup_mask, eng.blank_mask, True,
                                 eng.max_initial_index)
        home = _GraphHome(eng.device)
        restore()
        home.warm_up(body)
        restore()
        graph = home.capture(body)

        def turn(step):
            restore()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            for _ in range(STEP_GRAPH_STEPS):
                step()
            e1.record()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            out = (st.tokens_out.clone(), st.n_past.clone(), st.logits.clone())
            return e0.elapsed_time(e1) / STEP_GRAPH_STEPS, host * 1e3 / STEP_GRAPH_STEPS, out

        runs = {"eager": [], "graph": []}
        outs = {}
        for kind in ("eager", "graph", "graph", "eager"):
            ms, host_ms, outs[kind] = turn(body if kind == "eager" else graph.replay)
            runs[kind].append((ms, host_ms))
    if not all(torch.equal(a, b) for a, b in zip(outs["eager"], outs["graph"])):
        raise AssertionError("engine step graph: the replays' tokens, positions or logits differ "
                             "from the eager steps'")
    row = {kind: {"ms": sum(m for m, _ in r) / len(r), "host_ms": sum(h for _, h in r) / len(r)}
           for kind, r in runs.items()}
    log(f"[engine-step-graph] large-v3 int8, {STEP_GRAPH_SLOTS + 1} rows, pool of "
        f"{eng.pool_ctx} positions, {STEP_GRAPH_STEPS} steps a turn in turns (eager, graph, "
        f"graph, eager): eager {row['eager']['ms']:.4f} ms a step (host enqueue "
        f"{row['eager']['host_ms']:.4f}), one replay {row['graph']['ms']:.4f} ms (host "
        f"{row['graph']['host_ms']:.4f}); each turn {runs}; tokens, positions and logits equal; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}")
    del graph, home, eng, model, st, start, outs
    torch.cuda.empty_cache()
    return row


BEAM_PARITY_SECONDS = (2, 4, 6, 8, 10, 12)  # phase 24: six streams on 2 groups of 3 rows
BEAM_PARITY_K = 3


def _beam_engine_reference(eng, audio) -> list:
    """One stream alone through the device beam (beam_decode_device) on the
    beam engine's own model, with its cache kind, context, prompt, rule masks
    and finalize: the tokens the engine must give that stream."""
    model, k = eng.model, eng.beam_size
    with torch.inference_mode():
        a = torch.from_numpy(np.asarray(audio, np.float32)).to(eng.device)
        mel = log_mel_spectrogram(a, model.filters, frame_count(len(audio)))
        enc = encode(model.encoder, mel_window(mel, 0, 2 * model.config.n_audio_ctx)[None],
                     quantize_kv=eng.quantize)
        cache = eng._fresh_cache(k, getattr(enc.cross_k, "data", enc.cross_k).dtype)
        out = beam_decode_device(
            model.decoder, eng._padded_init.expand(k, -1), eng.init_len, eng.sot_index, cache,
            enc.cross_k, enc.cross_v, eng.sup_mask, eng.blank_mask, beam_size=k,
            sample_len=eng.max_new, use_timestamps=not eng.options.without_timestamps,
            max_initial_index=eng.max_initial_index)
    toks, lp, fin_t, fin_s, fin_l, fin_c, steps, nosp = out
    host = [t.cpu().numpy() for t in (toks, lp, fin_t, fin_s, fin_l, fin_c, nosp)]
    return eng._finalize_group(0, np.array([steps]), *host).tokens


def phase_beam_engine_parity(card: str) -> None:
    """The BeamSlotEngine on phase 4's tiny f32 checkpoint, on the CPU and on
    the card: six streams of different lengths on 2 groups of 3 rows (groups
    reused, a partial bucket), float and int8 (int8 decoder weights and
    pools: K4 at both sites), each stream's tokens the device beam's on that
    device and the card's equal to the CPU's; on the card under every
    schedule (the CPU tests cover the CPU's), the overlapped one making no
    synchronizing CUDA call besides its harvest pulls, then beam-2
    transcribe_streams over a 35 s and an 8 s clip giving
    pipeline.transcribe's segments (device beam route). The references run
    before the launch counts are set to 0."""
    cfg, path = tiny_checkpoint()
    audios = [synthetic_audio(SAMPLE_RATE * sec, seed=60 + sec) for sec in BEAM_PARITY_SECONDS]
    opts = DecodingOptions(beam_size=BEAM_PARITY_K, sample_len=24)
    got_by = {}
    for dev in ("cpu", "cuda"):
        base = load_model(str(path), device=dev, dtype=torch.float32)
        for quantize in (False, True):
            model = (base.with_params(quantize_decoder_weights(base.params)) if quantize
                     else base)
            mode = "int8" if quantize else "float"
            # the device beam's tokens first: its own K7 and K5 (or K4)
            # launches must not count as the engine's
            ref = [_beam_engine_reference(BeamSlotEngine(model, n_slots=2, options=opts,
                                                         quantize=quantize), a)
                   for a in audios]
            _zero_launches()
            for sched in SCHEDULES if dev == "cuda" else ("pipelined",):
                eng = BeamSlotEngine(model, n_slots=2, options=opts, chunk_steps=4,
                                     quantize=quantize, schedule=sched)
                watch = dev == "cuda" and sched == "overlapped"
                t0 = time.perf_counter()
                with host_waits(watch) as waits:
                    got = [r.tokens for r in eng.transcribe_many(audios)]
                wall = time.perf_counter() - t0
                if watch:
                    log(f"[beam-engine-parity] {dev} {mode} {sched}: {len(waits)} synchronizing "
                        f"CUDA calls besides the harvest pulls{': ' if waits else ''}"
                        f"{', '.join(waits)}")
                    if waits:
                        raise AssertionError(f"the overlapped beam engine waited on the card "
                                             f"outside its harvest pulls at {waits}")
                forks = eng.fork_stats()
                log(f"[beam-engine-parity] {dev} {mode} {sched}: {len(audios)} streams on 2 groups "
                    f"of {BEAM_PARITY_K}, {sum(map(len, got))} tokens in {wall * 1e3:.1f} ms, "
                    f"{forks['steps']} steps, {forks['forked_rows']} forked rows (at most "
                    f"{forks['max_forked_rows']} in a step of {forks['rows']} rows), stats "
                    f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in eng.stats.items()} }"
                    f": {'equal to' if got == ref else 'NOT EQUAL TO'} the device beam's tokens")
                if got != ref:
                    i = next(i for i, (g, r) in enumerate(zip(got, ref)) if g != r)
                    raise AssertionError(f"beam engine {dev} {mode} {sched}: stream {i} parts "
                                         f"from the device beam at token "
                                         f"{_first_divergence(got[i], ref[i])}")
                got_by.setdefault((dev, mode), got)
            n = _read_launches()
            ragged = n["k4_ragged"] if quantize else n["k5_ragged"]
            log(f"[beam-engine-parity] {dev} {mode}: the engine's launches {n}")
            if dev == "cuda" and (ragged == 0 or n["k7"] == 0):
                raise AssertionError(f"the {mode} beam engine on the card launched no ragged "
                                     f"kernel or no K7: {n}")
    topts = TranscribeOptions(temperature=0.0, beam_size=2, condition_on_previous_text=True,
                              use_device_loop=True)
    longs = [synthetic_audio(SAMPLE_RATE * 35, seed=1), synthetic_audio(SAMPLE_RATE * 8, seed=3)]
    eng = BeamSlotEngine(base, n_slots=2, chunk_steps=8, options=DecodingOptions(beam_size=2))
    got = eng.transcribe_streams(longs, topts)
    for i, (g, a) in enumerate(zip(got, longs)):
        _same_segments(f"beam engine streams stream {i}", transcribe(base, a, topts), g)
    log(f"[beam-engine-parity] cuda transcribe_streams, beam 2: 35 s and 8 s clips, "
        f"{eng.stats['windows']} windows, {sum(len(g['segments']) for g in got)} segments, "
        f"each the offline transcribe's (tokens, seek, t0, t1); {card}")
    for mode in ("float", "int8"):
        same = sum(c == g for c, g in zip(got_by[("cpu", mode)], got_by[("cuda", mode)]))
        log(f"[beam-engine-parity] {mode}: {same} of {len(audios)} streams token-identical on "
            f"the CPU and the card")
        if same != len(audios):
            raise AssertionError(f"the {mode} beam engine's tokens differ between the CPU and "
                                 f"the card")


def _float_beam_run(card: str, model, streams, tag: str):
    """One float BeamSlotEngine run at full width (see
    phase_beam_engine_float) under checking_kernels; each window's tokens
    beside the device beam's (decode_full on the device loop) on that window
    alone, with the window's prompt and budget. Returns (launches, fork
    stats, windows, windows token-identical, [(stream, seek, parting token,
    engine's avg_logprob, the device beam's)] of the others); the
    references run after the launches are read."""
    cfg = model.config
    L = cfg.n_text_layer
    topts = TranscribeOptions(temperature=0.0, beam_size=BEAM)
    eng = BeamSlotEngine(model, n_slots=FLOAT_ENGINE_SLOTS, chunk_steps=16,
                         options=DecodingOptions(beam_size=BEAM),
                         max_new_tokens=FLOAT_ENGINE_TOKENS)
    windows = []  # (stream, seek, its DecodingOptions, the engine's result)
    real_advance = eng._advance_stream

    def advance_spy(s, st, pulled, topts_, temps):
        windows.append((st, st["seek"], eng._window_options(st, topts_, 0.0),
                        eng._stream_result(s, pulled)))
        return real_advance(s, st, pulled, topts_, temps)

    eng._advance_stream = advance_spy
    checked = {}
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    with checking_kernels(checked):
        t0 = time.perf_counter()
        res = eng.transcribe_streams(streams, topts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = _read_launches()
    forks, st = eng.fork_stats(), eng.stats
    seconds = sum(len(a) for a in streams) / SAMPLE_RATE
    log(f"[beam-engine-float] {tag}: large-v3 {str(model.dtype)[6:]}, beam {BEAM}, "
        f"{len(streams)} streams ({seconds:.1f} s of audio), {FLOAT_ENGINE_SLOTS} groups "
        f"({forks['rows']} rows), pool of {eng.pool_ctx} positions, windows of up to "
        f"{FLOAT_ENGINE_TOKENS} tokens at t=0, kernels checked: {wall * 1e3:.1f} ms; "
        f"{st['windows']} windows, {st['rounds']} rounds, {forks['steps']} decode steps, forked "
        f"rows {forks['forked_rows'] / max(forks['steps'], 1):.2f} a step on average, at most "
        f"{forks['max_forked_rows']}; {sum(len(r['segments']) for r in res)} segments; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {n}; {card}")
    check_path_shapes("beam-engine-float", f"the {tag} float beam engine's path", checked)
    if not (n["k1"] + n["k1_f32"] > 0 and n["k7"] == forks["steps"] > 0
            and n["k5_ragged"] == L * forks["steps"] and n["k5"] > n["k5_ragged"]
            and (n["k5"] - n["k5_ragged"]) % L == 0 and forks["rows"] == FLOAT_BEAM_GROUPS * BEAM):
        raise AssertionError(f"the {tag} float beam engine's launches {n} over "
                             f"{forks['steps']} steps: K7 once a step and the ragged K5 once a "
                             f"layer a step")
    if st["windows"] != len(windows) or st["windows"] < 2 * len(streams) or [
            r["duration"] for r in res] != [len(a) / SAMPLE_RATE for a in streams]:
        raise AssertionError(f"bad streams: {st['windows']} windows, {res}")
    for r in res:
        for seg in r["segments"]:
            if not (all(0 <= t < cfg.n_vocab for t in seg["tokens"])
                    and math.isfinite(seg["avg_logprob"])
                    and 0.0 <= seg["t0"] <= seg["t1"] <= r["duration"] + 30):
                raise AssertionError(f"bad segment {seg}")
    same, parted = 0, []
    with torch.inference_mode():
        for stream, seek, wopts, got in windows:
            enc = model.encoder(mel_window(stream["mel"], seek, eng._n_frames)[None])
            want = decode_full(model.decoder, model.vocab, enc.cross_k, enc.cross_v,
                               dataclasses.replace(wopts, sample_len=FLOAT_ENGINE_TOKENS),
                               use_device_loop=True)[0]
            same += got.tokens == want.tokens
            if got.tokens != want.tokens:
                parted.append((stream["idx"], seek, _first_divergence(got.tokens, want.tokens),
                               round(got.avg_logprob, 4), round(want.avg_logprob, 4)))
    log(f"[beam-engine-float] {tag}: {same} of {len(windows)} windows token-identical to the "
        f"device beam's on the window alone; the others (stream, seek, parting token, the "
        f"engine's avg_logprob, the device beam's): {parted}")
    del eng
    torch.cuda.empty_cache()
    return n, forks, len(windows), same, parted


def phase_beam_engine_float(card: str, model, streams) -> dict:
    """The float BeamSlotEngine at full width, as ``cli serve --beam 5``
    loads it: phase 5's large-v3 bf16 model, beam 5 over FLOAT_ENGINE_SLOTS
    groups (FLOAT_BEAM_GROUPS x 5 rows of pools of FLOAT_ENGINE_CTX
    positions: K5 with each group's n_past in device memory, K7 over the
    pool's K and V), transcribe_streams over phase 22's four streams at t=0
    with windows of up to FLOAT_ENGINE_TOKENS tokens, holding K1 and K5 to
    their plain versions at every shape the path gives them. Then the same
    at f32 (large-v3 drawn on the card, seed 0), where each window's tokens
    must equal the device beam's on that window alone. At bf16 they are
    compared and not held: the engine's GEMMs run at 85 rows and its
    prefill at one row a group, the device beam's at 5 and 5, and bf16
    rounds those sums apart, which moves near-tied beams. Returns the bf16
    run's launches."""
    n, forks, _, _, _ = _float_beam_run(card, model, streams, "as served")
    f32 = random_model(model.config, seed=0, dtype=torch.float32, device="cuda")
    _, _, windows, same, parted = _float_beam_run(card, f32, streams, "f32")
    del f32
    torch.cuda.empty_cache()
    if parted:
        raise AssertionError(f"the f32 beam engine parts from the device beam in "
                             f"{windows - same} of {windows} windows: {parted}")
    return {**n, "forks": forks}


def phase_beam_engine_bench(card: str) -> dict:
    """python -m whisper_tpu_torch.utils.benchmark with BENCH_MODE=engine and
    BENCH_BEAM=5 in a subprocess: large-v3 int8 at bench.py's beam engine
    defaults (32 groups of 5 rows and the trash group, 64 streams of
    24/27/30 s, chunks of 16, 64 tokens). Returns its launches over the
    timed waves, with the step count."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_MODE="engine", BENCH_BEAM=str(BEAM), BENCH_SECONDS=str(ENGINE_BENCH_SECONDS))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.utils.benchmark"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(out) != 1:
        raise AssertionError(f"beam engine bench: exit {proc.returncode}, stdout {out}, stderr "
                             f"{proc.stderr[-3000:]}")
    print(out[0], flush=True)
    line = json.loads(out[0])
    d = line["detail"]
    n, est, forks = d["kernel_launches"], d["hbm_estimate"], d["forks"]
    alloc, reserved = d["peak_allocated_bytes"], d["peak_reserved_bytes"]
    layers = PRESETS["large-v3"].n_text_layer
    prefills = (n["k4_self"] - n["k4_ragged"]) // layers
    fold = n["k4"] - n["k4_self"] - prefills * layers
    log(f"[beam-engine-bench] {line['metric']} = {line['value']:.3f} {line['unit']} "
        f"({d['waves']} waves of {d['n_streams']} streams in {d['wall_s']:.3f} s after a "
        f"{d['warmup_s']:.3f} s warm-up; {d['tokens_last_wave']} tokens in the last wave; its "
        f"stats { {k: round(v, 4) if isinstance(v, float) else v for k, v in d['stats'].items()} }; "
        f"{wall:.1f} s for the process); {forks['steps']} decode steps over {forks['rows']} rows: "
        f"forked rows {forks['forked_rows'] / max(forks['steps'], 1):.2f} a step on average, at "
        f"most {forks['max_forked_rows']}; launches over the timed waves: K4 cross fold "
        f"{fold} at the step and {prefills * layers} at {prefills} prefills, K4 self "
        f"{n['k4_self'] - n['k4_ragged']} at the prefills, ragged K4 self {n['k4_ragged']}, K7 "
        f"{n['k7']}, K1 {n['k1']} (all {n}); memory guard at beam {BEAM}: estimate "
        f"{est['total'] / 1e9:.3f} GB (budget {est['budget'] / 1e9:.3f} GB), peak allocated "
        f"{alloc / 1e9:.3f} GB, reserved {reserved / 1e9:.3f} GB (reserved / estimate "
        f"{reserved / est['total']:.3f}); {d['nvidia_smi']}")
    slots = BEAM_ENGINE_GROUPS - 1
    want = f"rtf_torch_large-v3_engine_s{slots}_q{2 * slots}_beam{BEAM}_int8"
    if not (line["metric"] == want and line["value"] > 0 and line["vs_baseline"] is None
            and d["waves"] >= 1 and d["n_results"] == 2 * slots and d["nvidia_smi"]
            and d["device"].startswith("cuda") and d["torch"] == torch.__version__
            and d["beam_size"] == BEAM and forks["rows"] == BEAM_ENGINE_GROUPS * BEAM):
        raise AssertionError(f"beam engine bench: bad line {line}")
    # one K7 and one ragged K4 self a layer at every decode step, the fold
    # at every step and prefill
    if not (n["k1"] > 0 and n["k7"] == forks["steps"] > 0
            and n["k4_ragged"] == layers * forks["steps"] and prefills > 0
            and fold == layers * forks["steps"]):
        raise AssertionError(f"beam engine bench: launches {n} over {forks['steps']} steps")
    st = d["stats"]
    if st["staged_buckets"] * ENGINE_BUCKET != 2 * slots:
        raise AssertionError(f"beam engine bench: {st['staged_buckets']} admission buckets for "
                             f"{2 * slots} streams, not all of {ENGINE_BUCKET}: shapes outside "
                             f"K4_CASES")
    if reserved > PEAK_OVER_ESTIMATE * est["total"]:
        raise AssertionError(f"beam engine bench: peak reserved {reserved} bytes, more than "
                             f"PEAK_OVER_ESTIMATE ({PEAK_OVER_ESTIMATE}) times the guard's "
                             f"estimate {est['total']}")
    return {**n, "prefills": prefills, "fold": fold, "forks": forks}


def _wav_bytes(samples: np.ndarray) -> bytes:
    """16-bit WAV bytes of samples read from a 16-bit WAV (k / 32768): the
    server decodes exactly these samples back."""
    buf = io.BytesIO()
    write_wav(buf, np.round(np.asarray(samples) * 32768).astype(np.int16))
    return buf.getvalue()


def _post(port: int, path: str, body: bytes, headers=None):
    """(status, body bytes) of one POST to 127.0.0.1:port, bounded."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@contextlib.contextmanager
def http_front(srv):
    """make_http_server over ``srv`` on 127.0.0.1, port 0, served from a
    thread; yields the port and shuts down on exit."""
    httpd = make_http_server(srv, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


class _GatedQueue(queue.Queue):
    """An EngineServer's request queue that hands out nothing until ``n``
    requests are in it (a wait of at most 600 s): the requests reach the
    worker together, as transcribe_streams' streams do, so both admit them
    in the same buckets. A bf16 encode is not batch-invariant: a request
    admitted alone can part one text from its bucketed run."""

    def __init__(self, n: int):
        super().__init__()
        self.n, self.open = n, False

    def get(self, block=True, timeout=None):
        end = time.monotonic() + 600
        while not self.open and self.qsize() < self.n:
            if time.monotonic() > end:
                raise AssertionError(f"the gate saw {self.qsize()} of {self.n} requests")
            time.sleep(0.001)
        self.open = True
        return super().get(block, timeout)


def _same_result(name: str, want: dict, got: dict) -> None:
    if got["text"] != want["text"] or [s["tokens"] for s in got["segments"]] != [
            s["tokens"] for s in want["segments"]]:
        raise AssertionError(f"{name}: the server's result differs from transcribe_streams'")


def _cli_entry_points(card: str) -> None:
    """The CLI's two engine commands on the card, as a user runs them
    (bf16, subprocesses, phase 4's checkpoint): ``batch --beam 2`` over two
    WAVs must print what this process's BeamSlotEngine gives on the same
    model, options and samples; ``serve --beam 5`` must announce its port,
    answer GET /healthz and POST /transcribe of an 8 s clip with a result of
    the clip's duration, and exit 0 on SIGTERM. Served requests take the
    whole temperature ladder (serve sets no thresholds), which a random
    model fails at every rung: at large-v3 a window costs ~84 s (a 40 s
    request took 168.6 s on an H100), so the served model here is the
    small one; phase 24 runs the same engine at large-v3. Every wait is
    bounded and the server is killed if it is still up."""
    _, path = tiny_checkpoint()
    wavs = [_wav_clip(sec, seed=300 + sec) for sec in (6, 11)]
    cli = [sys.executable, "-m", "whisper_tpu_torch.cli"]
    t0 = time.perf_counter()
    proc = subprocess.run(cli + ["batch", str(path), *(p for p, _ in wavs), "--beam", "2",
                                 "--slots", "2"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    tiny = load_model(str(path), device="cuda", dtype=torch.bfloat16)
    eng = BeamSlotEngine(tiny, n_slots=2,
                         options=DecodingOptions(beam_size=2, without_timestamps=True))
    want = [f"== {p}: {r.text}" for (p, _), r in zip(wavs, eng.transcribe_many(
        [a for _, a in wavs]))]
    got = proc.stdout.strip().splitlines()[:-1]
    log(f"[cli-engine] python -m whisper_tpu_torch.cli batch --beam 2 --slots 2 (tiny, bf16, on "
        f"the card): exit {proc.returncode} in {time.perf_counter() - t0:.1f} s, its lines "
        f"{'equal to' if got == want else 'NOT EQUAL TO'} this process's BeamSlotEngine's")
    if proc.returncode != 0 or got != want:
        raise AssertionError(f"cli batch --beam: exit {proc.returncode}, stdout {got}, want "
                             f"{want}, stderr {proc.stderr[-2000:]}")
    del eng, tiny

    t0 = time.perf_counter()
    stream = wavs[1][1][: 8 * SAMPLE_RATE]
    server = subprocess.Popen(cli + ["serve", str(path), "--beam", str(BEAM),
                                     "--slots", "4", "--port", "0"],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
    lines: queue.Queue = queue.Queue()  # its output, drained so that it never blocks
    seen: list = []
    threading.Thread(target=lambda: [(seen.append(ln), lines.put(ln)) for ln in server.stdout],
                     daemon=True).start()
    try:
        port = None
        end = time.monotonic() + 600
        while port is None:
            try:
                ln = lines.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                raise AssertionError("cli serve did not announce its port in 600 s") from None
            if ln.startswith("serving on http://"):
                port = int(ln.split()[2].rsplit(":", 1)[1])
        ready = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        t1 = time.perf_counter()
        status, body = _post(port, "/transcribe", _wav_bytes(stream))
        took = time.perf_counter() - t1
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=300)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    res = json.loads(body) if status == 200 else {}
    seconds = len(stream) / SAMPLE_RATE
    log(f"[cli-engine] python -m whisper_tpu_torch.cli serve (tiny, bf16, --beam {BEAM}, "
        f"--slots 4): serving after {ready:.1f} s, /healthz {health}, POST /transcribe of "
        f"{seconds:.1f} s: HTTP {status} in {took * 1e3:.1f} ms, "
        f"{len(res.get('segments', []))} segments; exit {rc} on SIGTERM; {card}")
    if not (health.get("ok") and status == 200 and rc == 0 and res.get("duration") == seconds
            and isinstance(res.get("text"), str) and res.get("segments")):
        raise AssertionError(f"cli serve --beam {BEAM}: /healthz {health}, HTTP {status} "
                             f"{body[:300]}, exit {rc}, output {''.join(seen)[-2000:]}")


def phase_server(card: str, model, float_streams, float_results) -> dict:
    """EngineServer behind make_http_server on 127.0.0.1 (port 0): phase 4's
    tiny checkpoint greedy and with beam 2 (a BeamSlotEngine) answers
    /transcribe, /transcribe?stream=1 and /v1/audio/transcriptions with the
    same engine's transcribe_streams results; then phase 22's large-v3 bf16
    float engine takes phase 22's four streams as concurrent HTTP requests
    (released to the worker together, ``_GatedQueue``), and their texts
    must be phase 22's; then the CLI's batch --beam and serve --beam 5 as
    subprocesses (``_cli_entry_points``). Returns the large-v3 server
    run's launches."""
    cfg, path = tiny_checkpoint()
    tiny = load_model(str(path), device="cuda", dtype=torch.float32)
    short, long_ = (load_wav_bytes(_wav_bytes(synthetic_audio(SAMPLE_RATE * sec, seed=sec)))
                    for sec in (8, 35))
    boundary = "XsMoKeX"
    multipart = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                 f'filename="a.wav"\r\n\r\n').encode() + _wav_bytes(short) + (
        f'\r\n--{boundary}\r\nContent-Disposition: form-data; name="response_format"\r\n\r\n'
        f'verbose_json\r\n--{boundary}--\r\n').encode()
    for beam in (None, 2):
        topts = TranscribeOptions(temperature=0.0, beam_size=beam,
                                  condition_on_previous_text=True)
        eng = (BeamSlotEngine(tiny, n_slots=2, chunk_steps=8, options=DecodingOptions(beam_size=2))
               if beam else SlotEngine(tiny, n_slots=2, chunk_steps=8))
        want_short, want_long = eng.transcribe_streams([short, long_], topts)
        t0 = time.perf_counter()
        with EngineServer(eng, topts) as srv, http_front(srv) as port:
            status, body = _post(port, "/transcribe", _wav_bytes(short))
            if status != 200:
                raise AssertionError(f"/transcribe: HTTP {status} {body[:300]}")
            _same_result("/transcribe", want_short, json.loads(body))
            status, body = _post(port, "/transcribe?stream=1", _wav_bytes(long_))
            lines = [json.loads(ln) for ln in body.splitlines()]
            segs = [ln["segment"] for ln in lines[:-1]]
            if status != 200 or not lines[-1].get("done"):
                raise AssertionError(f"?stream=1: HTTP {status}, last line {lines[-1:]}")
            _same_result("?stream=1", want_long, {"text": lines[-1]["text"], "segments": segs})
            status, body = _post(port, "/v1/audio/transcriptions", multipart, {
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
            if status != 200:
                raise AssertionError(f"/v1/audio/transcriptions: HTTP {status} {body[:300]}")
            _same_result("/v1/audio/transcriptions", want_short, json.loads(body))
            lat = srv.latency_stats()
        log(f"[server] tiny f32 {'beam 2' if beam else 'greedy'}: /transcribe (8 s), "
            f"?stream=1 (35 s, {len(segs)} segment lines before the summary) and "
            f"/v1/audio/transcriptions verbose_json each equal to the engine's "
            f"transcribe_streams; {(time.perf_counter() - t0) * 1e3:.1f} ms, latency {lat}; {card}")

    eng = SlotEngine(model, n_slots=FLOAT_ENGINE_SLOTS, chunk_steps=32,
                     max_new_tokens=FLOAT_ENGINE_TOKENS)
    bodies = [_wav_bytes(a) for a in float_streams]
    got = [None] * len(bodies)
    _zero_launches()
    srv = EngineServer(eng, TranscribeOptions(temperature=0.0))
    srv._queue = _GatedQueue(len(bodies))
    with srv, http_front(srv) as port:
        def client(i):
            got[i] = _post(port, "/transcribe", bodies[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        lat, stats = srv.latency_stats(), dict(eng.stats)
    n = _read_launches()
    if any(t.is_alive() for t in threads) or any(g is None or g[0] != 200 for g in got):
        raise AssertionError(f"large-v3 server: requests failed: {[g and g[0] for g in got]}")
    texts = [json.loads(g[1])["text"] for g in got]
    same = sum(t == r["text"] for t, r in zip(texts, float_results))
    seconds = sum(len(a) for a in float_streams) / SAMPLE_RATE
    log(f"[server] large-v3 bf16 float engine ({FLOAT_ENGINE_SLOTS} slots): {len(bodies)} "
        f"concurrent POST /transcribe ({seconds:.1f} s of audio) in {wall * 1e3:.1f} ms, "
        f"{seconds / wall:.3f} s of audio per wall second; latency {lat}; stats "
        f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()} }; "
        f"launches {n}; {same} of {len(texts)} texts equal to phase 22's; {card}")
    if same != len(texts):
        raise AssertionError("large-v3 server: the texts differ from phase 22's transcribe_streams")
    if n["k1"] == 0 or n["k5_ragged"] == 0:
        raise AssertionError(f"large-v3 server: K1 and the ragged K5 must run: {n}")
    del eng
    torch.cuda.empty_cache()
    _cli_entry_points(card)
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
    guard_reading("int8-main", *guarded(model.config)[1][1:])  # phase 8's peaks
    rows.update(phase_decode_kernels(card))
    phase_beam_parity(card)
    beam = phase_int8_beam_main_path(card, served)
    guard_reading("int8-beam", *guarded(model.config)[2][1:])  # phase 11's
    host = phase_host_beam(card, model)
    phase_whisper_full_parity(card)
    wf = phase_whisper_full(card, model)
    chunked = phase_chunked_streaming_cli(card, model)
    phase_engine_parity(card)
    fe, fe_streams, fe_results = phase_engine_float(card, model)
    phase_beam_engine_parity(card)
    bef = phase_beam_engine_float(card, model, fe_streams)
    srv = phase_server(card, model, fe_streams, fe_results)
    del model, served
    torch.cuda.empty_cache()
    bench = phase_bench(card)
    greedy, beam_bench = bench["greedy-b64"], bench["beam5-b48"]
    eb = phase_engine_bench(card)
    phase_engine_step_graph(card)
    beb = phase_beam_engine_bench(card)
    train_rows, k1b_entry = phase_train_kernels(card)
    phase_train_parity(card)
    train = phase_train(card)
    rt = phase_roundtrip(card)
    src, tpu = "whisper_tpu_torch/csrc/", "whisper_tpu/kernels/"
    entries = [
        # K1's bf16 kernel on every encode path (phases 5 and 8, whisper_full's
        # phase 17, chunked's phase 19 and both bench runs of phase 18), with
        # the b8 row; the b64 row beside it with phase 8's launches
        ("flash_attention", "flash_attention.cu", "flash_attention.py:141",
         bf16["k1"] + n["k1"] + wf["k1"] + chunked["k1"] + greedy["k1"] + beam_bench["k1"]
         + fe["k1"] + eb["k1"] + beb["k1"] + srv["k1"] + bef["k1"], k1["b8"]),
        ("flash_attention.b64", "flash_attention.cu", "flash_attention.py:141", n["k1"],
         k1["b64"]),
        # the int8 step's kernels: phase 8 and both bench runs (the greedy
        # bench's K4 in the b64 rows, the beam bench's in rows of its own)
        ("fused_quant.act_quant", "fused_quant.cu", "fused_quant.py:113",
         n["act"] + greedy["act"] + beam_bench["act"], rows["act"]),
        ("fused_quant.ln_quant", "fused_quant.cu", "fused_quant.py:113",
         n["ln"] + greedy["ln"] + beam_bench["ln"], rows["ln"]),
        ("fused_quant.gelu_quant", "fused_quant.cu", "fused_quant.py:113",
         n["gelu"] + greedy["gelu"] + beam_bench["gelu"], rows["gelu-erf"]),
        ("cross_attention_int8.cross", "cross_attention_int8.cu", "cross_attention_int8.py:109",
         n["k4"] - n["k4_self"] + greedy["k4"] - greedy["k4_self"], rows["cross"]),
        ("cross_attention_int8.self", "cross_attention_int8.cu", "cross_attention_int8.py:109",
         n["k4_self"] + greedy["k4_self"], rows["self"]),
        # K4 cross with the beam fold (5 query rows a window): phase 11's
        # launches at 32 windows, and the beam bench's at 48 with its self
        # cache of 240 rows
        ("cross_attention_int8.cross_beam", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", beam["k4"] - beam["k4_self"], rows["cross-beam5"]),
        ("cross_attention_int8.cross_beam.b48", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", beam_bench["k4"] - beam_bench["k4_self"],
         rows["cross-beam5-b48"]),
        ("cross_attention_int8.self_beam.b48", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", beam_bench["k4_self"], rows["self-beam-b48"]),
        # the int8 engine bench (phase 23): cross at 65 rows (its prefill's
        # cross at (16, 20, 32) in the same count), the prefill's self over
        # the pool at n_past 0, and self with each slot's n_past read from
        # device memory
        ("cross_attention_int8.cross.engine", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", eb["k4"] - eb["k4_self"], rows["engine-cross"]),
        ("cross_attention_int8.self_prefill.engine", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", eb["k4_self"] - eb["k4_ragged"],
         rows["engine-self-t32"]),
        ("cross_attention_int8.self_ragged", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", eb["k4_ragged"], rows["engine-self"]),
        # the int8 beam engine bench (phase 25): the cross fold at every step
        # (5 query rows a group), the admission prefill's cross and self (one
        # row a group, at the greedy engine's shapes), and self with each
        # group's n_past read from device memory; K7's fork copies over its
        # 165-row pool, at the typical fork count, the storm's times beside
        ("cross_attention_int8.cross_beam.engine", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", beb["fold"], rows["beam-engine-cross"]),
        ("cross_attention_int8.cross_prefill.beam_engine", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", beb["k4"] - beb["k4_self"] - beb["fold"],
         rows["engine-cross-t32"]),
        ("cross_attention_int8.self_prefill.beam_engine", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", beb["k4_self"] - beb["k4_ragged"],
         rows["engine-self-t32"]),
        ("cross_attention_int8.self_ragged.beam_engine", "cross_attention_int8.cu",
         "cross_attention_int8.py:109", beb["k4_ragged"], rows["beam-engine-self"]),
        # K5 on the bf16 paths, each row with its launches: phase 5's greedy
        # batch, whisper_full (phase 17) and chunked (phase 19), and phase
        # 12's host beam (both rows carry the CUDA-graph time); the float
        # engines' prefills in the first
        ("cached_attention", "decode_attention.cu", "decode_attention.py:109",
         bf16["k5"] + wf["k5"] + chunked["k5"] + fe["k5"] - fe["k5_ragged"] + srv["k5"]
         - srv["k5_ragged"] + bef["k5"] - bef["k5_ragged"], rows["k5-b8"]),
        # the float engine's step (phase 22, and behind the server in phase
        # 26): each slot's n_past read from device memory
        ("cached_attention.ragged", "decode_attention.cu", "decode_attention.py:109",
         fe["k5_ragged"] + srv["k5_ragged"], rows["k5-engine"]),
        ("cached_attention.beam", "decode_attention.cu", "decode_attention.py:109", host["k5"],
         rows["k5-beam"]),
        # the float beam engine at full width (phase 24's large-v3 run): 85
        # rows, each group's n_past read from device memory
        ("cached_attention.ragged.beam_engine", "decode_attention.cu", "decode_attention.py:109",
         bef["k5_ragged"], rows["k5-beam-engine"]),
        ("permute_rows_multi", "beam_gather.cu", "beam_gather.py:159", host["k6"],
         rows["k6-bf16"]),  # the host beam's float cache
        ("cow_copy_rows", "beam_gather.cu", "beam_gather.py:280", beam["k7"], rows["k7-96"]),
        ("cow_copy_rows.b48", "beam_gather.cu", "beam_gather.py:280", beam_bench["k7"],
         rows["k7-144"]),
        ("cow_copy_rows.engine", "beam_gather.cu", "beam_gather.py:280", beb["k7"],
         {**rows[_k7_name(BEAM_ENGINE_FORKS, ENGINE_CTX)],
          "forks": BEAM_ENGINE_FORKS, **{f"storm_{key}": value for key, value in rows[
              _k7_name(BEAM_ENGINE_GROUPS * (BEAM - 1), ENGINE_CTX)].items()
              if key in ("ms", "plain_ms", "bound_ms", "library_ms")},
          "storm_forks": BEAM_ENGINE_GROUPS * (BEAM - 1)}),
        # and over the float beam engine's bf16 pool (phase 24's large-v3 run)
        ("cow_copy_rows.float_engine", "beam_gather.cu", "beam_gather.py:280", bef["k7"],
         {**rows[_k7_name(FLOAT_BEAM_FORKS, FLOAT_ENGINE_CTX, torch.bfloat16)],
          "forks": FLOAT_BEAM_FORKS}),
        # The large-v3 training path's kernels (phase 15), at the encoder's
        # shape: K1's f32 kernel (K1c's forward) alone, K1c's backward kernel
        # alone, and K1c forward and backward, with the forward's launches,
        # every one through flash_sdpa
        ("flash_attention.f32", "flash_attention.cu", "flash_attention.py:141", train["k1_f32"],
         train_rows["k1-f32"]),
        ("flash_sdpa.backward", "flash_attention_bwd.cu", "flash_attention.py:193",
         train["k1c_bwd"], train_rows["k1c-bwd-1500-float32"]),
        ("flash_sdpa", "flash_attention.cu", "flash_attention.py:183", train["k1_f32"],
         train_rows["k1c-1500-float32"]),
        # the tone-word fine-tune's (phase 20), at its encoder's shape (16,
        # 64, 64); its decoder's (16, 31, 31) causal is held in phase 13 too
        ("flash_sdpa.roundtrip", "flash_attention.cu", "flash_attention.py:183", rt["k1_f32"],
         train_rows["k1c-64-float32"]),
        ("flash_sdpa.backward.roundtrip", "flash_attention_bwd.cu", "flash_attention.py:193",
         rt["k1c_bwd"], train_rows["k1c-bwd-64-float32"]),
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
