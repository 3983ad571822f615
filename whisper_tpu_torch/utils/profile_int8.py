"""torch.profiler breakdown of the int8 serving step (large-v3, batch 64).

    python3 -m whisper_tpu_torch.utils.profile_int8   # repository root, one CUDA card

Loads chip_smoke.py's synthetic large-v3 checkpoint (writing it if it is not
there), prepares it as the int8 serving step does (``prepare_serving_params``)
and profiles one W8A8 encode with its int8 cross memory, one 16-token int8
greedy decode, and one 16-token int8 device beam (32 windows x beam 5 over
the first 32 windows' cross memory, as ``make_serving_step(beam_size=5)``
decodes), each after a warm run. For each it prints the wall time, the
device time, the busy share and K4's summed time, and the op table goes to
``build/profile/profile_<name>.txt``.

Device time counts the device's own events (kernels, memcpy, memset) once
each, as the table's "Self CUDA time total" does. The operator rows (aten::*)
carry their kernels' time as well, so a sum over every row would count it
twice.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

OUT = Path.cwd() / "build" / "profile"
BATCH, DECODE_TOKENS = 64, 16
GROUPS, BEAM = 32, 5


def report(name: str, prof, wall: float, card: str) -> None:
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(f"[profile] {name}: wall {wall * 1e3:.1f} ms (profiled), device {busy_ms:.1f} ms, "
          f"busy {busy_ms / (wall * 1e3):.1%}, kernel launches {launches}; {card}", flush=True)
    k4 = [e for e in device if "attention_int8_kernel" in e.key]
    print(f"[profile]   K4 (attention_int8_kernel, every instance): "
          f"{sum(e.self_device_time_total for e in k4) / 1e3:.2f} ms over "
          f"{sum(e.count for e in k4)} launches", flush=True)
    for e in sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:14]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6} {e.key[:90]}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=60))


def main() -> None:
    import chip_smoke as smoke  # the checkpoint writer and the synthetic audio

    from ..decoding.device_beam import beam_decode_device
    from ..decoding.device_loop import build_masks, decode_segment_device
    from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
    from ..kernels import build
    from ..model.decoder import KVCache
    from ..model.encoder import encode
    from ..model.load import load_model
    from ..model.quant import QuantKV, init_quant_cache
    from .benchmark import prepare_serving_params

    card = smoke.phase_device()
    build.build_all(smoke.KERNELS)
    cfg = smoke.PRESETS["large-v3"]
    path = smoke.CKPT_DIR / "large-v3-f16-seed0.bin"
    if not path.exists():
        smoke.CKPT_DIR.mkdir(parents=True, exist_ok=True)
        smoke.write_checkpoint(path, cfg, seed=0, scale=0.02)
    model = load_model(str(path), dtype=torch.bfloat16, device="cuda")
    model = model.with_params(prepare_serving_params(model.params))
    audio = torch.from_numpy(smoke.synthetic_audio(smoke.SAMPLE_RATE * 30, seed=100)).cuda()
    sup, blank = build_masks(model.vocab, "cuda")
    init = torch.full((BATCH, 1), model.vocab.token_sot, device="cuda")
    with torch.inference_mode():
        mel = mel_window(log_mel_spectrogram(audio, model.filters, frame_count(len(audio))),
                         0, 2 * cfg.n_audio_ctx)[None].expand(BATCH, -1, -1)

        def enc():
            return encode(model.encoder, mel, quantize_kv=True)

        def dec(e):
            cache = KVCache(*init_quant_cache(cfg, BATCH, "cuda", ctx=1 + DECODE_TOKENS + 8))
            return decode_segment_device(model.decoder, init, 1, 0, cache, e.cross_k, e.cross_v,
                                         sup, blank, sample_len=DECODE_TOKENS,
                                         use_timestamps=True)

        def beam(e):
            cache = KVCache(*init_quant_cache(cfg, GROUPS * BEAM, "cuda",
                                              ctx=1 + DECODE_TOKENS + 8))
            ck, cv = (QuantKV(x.data[:, :GROUPS], x.scale[:, :GROUPS])
                      for x in (e.cross_k, e.cross_v))
            return beam_decode_device(model.decoder, init[:1].expand(GROUPS * BEAM, 1), 1, 0,
                                      cache, ck, cv, sup, blank, beam_size=BEAM,
                                      sample_len=DECODE_TOKENS)

        e = enc()
        dec(e)
        beam(e)
        torch.cuda.synchronize()
        for name, fn in (("encode", enc), (f"decode{DECODE_TOKENS}", lambda: dec(e)),
                         (f"beam{DECODE_TOKENS}", lambda: beam(e))):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(name, prof, wall, card)


if __name__ == "__main__":
    main()
