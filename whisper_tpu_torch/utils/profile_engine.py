"""Where the engine bench's admission time goes (large-v3, int8, 64 slots).

    python3 -m whisper_tpu_torch.utils.profile_engine   # repository root, one CUDA card

Builds the engine bench's default engine (``run_engine_benchmark``: random
large-v3 weights from seed 0, int8 decoder weights and pools, 64 slots,
chunks of 32, 64 tokens, the overlapped schedule) and, after a warm wave:

- stages admission buckets of 16 streams (window, mel, encode, prefill;
  ``_window_batch`` and ``_encode_bucket``) with the card idle, one alone
  and then four back to back, and prints the host's wall for enqueuing
  them beside the card's time for running them (CUDA events); then
  profiles one such bucket: its largest kernels, and the CUDA runtime
  calls that held the host longest (where the host waits);
- profiles one wave of 128 streams with torch.profiler: wall, device time,
  busy share, the engine's stats, and the device time of K1, K4 and the
  largest kernels; the op table goes to ``build/profile/profile_engine.txt``.

Device time counts the device's own events once each, as profile_int8 does.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .profile_int8 import OUT

SLOTS, BUCKET = 64, 16


def stage_times(engine, audios, n_buckets: int) -> tuple:
    """(host ms to enqueue, device ms to run) ``n_buckets`` buckets staged
    back to back from an idle card."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(n_buckets):
        wins = engine._window_batch(audios[i * BUCKET: (i + 1) * BUCKET], BUCKET)
        engine._encode_bucket(wins, BUCKET)  # dropped: the next reuses its memory
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return host * 1e3, start.elapsed_time(end)


def device_rows(events, n: int) -> list:
    """The ``n`` device events with the most device time, and the total."""
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in device) / 1e3
    return sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:n], total


def print_rows(rows) -> None:
    for e in rows:
        print(f"[profile-engine]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6} "
              f"{e.key[:90]}", flush=True)


def main() -> None:
    import chip_smoke as smoke  # the card's line and the kernel sources

    from ..decoding.task import DecodingOptions
    from ..kernels import build
    from ..model.load import random_model
    from ..parallel.engine import SlotEngine
    from .benchmark import PRESETS, engine_streams, prepare_serving_params

    card = smoke.phase_device()
    build.build_all(smoke.KERNELS)
    model = random_model(PRESETS["large-v3"], seed=0, dtype=torch.bfloat16, device="cuda",
                         on_device=True)
    model = model.with_params(prepare_serving_params(model.params, "int8", "bfloat16"))
    audios = engine_streams(2 * SLOTS)
    seconds = sum(len(a) for a in audios) / 16000.0
    engine = SlotEngine(model, n_slots=SLOTS, chunk_steps=32,
                        options=DecodingOptions(without_timestamps=False), max_new_tokens=64,
                        quantize=True)
    engine.transcribe_many(audios)  # warm: every shape built, the allocator's pools filled
    with torch.inference_mode():
        for n in (1, 1, 4, 4):
            host, dev = stage_times(engine, audios, n)
            print(f"[profile-engine] {n} bucket(s) of {BUCKET} staged from an idle card: host "
                  f"{host:.1f} ms to enqueue, card {dev:.1f} ms to run; {card}", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stage_times(engine, audios, 1)
    events = prof.key_averages()
    rows, total = device_rows(events, 12)
    runtime = sorted((e for e in events if e.device_type == DeviceType.CPU
                      and e.key.startswith("cu")), key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:6]
    print(f"[profile-engine] one bucket staged, profiled: device {total:.1f} ms; the runtime "
          f"calls that held the host longest: "
          f"{', '.join(f'{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}' for e in runtime)}"
          f"; the largest kernels:", flush=True)
    print_rows(rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.transcribe_many(audios)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    rows, busy_ms = device_rows(events, 14)
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    st = engine.stats
    print(f"[profile-engine] one wave, {len(audios)} streams ({seconds:.1f} s of audio), "
          f"profiled: wall {wall * 1e3:.1f} ms, device {busy_ms:.1f} ms, busy "
          f"{busy_ms / (wall * 1e3):.1%}; stats "
          f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in st.items()} }; {card}",
          flush=True)
    for name, part in (("K1 (attention_bf16_kernel)", "attention_bf16_kernel"),
                       ("K4 (attention_int8_kernel)", "attention_int8_kernel")):
        hits = [e for e in device if part in e.key]
        print(f"[profile-engine]   {name}: {sum(e.self_device_time_total for e in hits) / 1e3:.2f}"
              f" ms over {sum(e.count for e in hits)} launches", flush=True)
    print_rows(rows)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile_engine.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=60))


if __name__ == "__main__":
    main()
