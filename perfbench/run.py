"""Run one cell of the benchmark once, on the card this process is given.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root. The cell is ``BENCHMARK.json``'s workload of that
name, its file ``perfbench/workloads/<cell>.json``, its configuration's
``perfbench/configs/<config>.json`` and the family that file names
(``perfbench/families/<family>.py``: the model's weights, program and
reference); per-layer metrics are read by ``perfbench/metrics/<metric>.py``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison with the
reference read, beside its limit. The same numbers end
standard error. Without a CUDA card, or with fewer than the cell asks for,
it exits 2 and prints no result.

``--control 1`` puts the control in the program's place in the comparison,
after the window (the family's ``readings(control=True)``): the result
line then judges the control, whose ``correct`` must come out false, and
standard error gives the program's own widest gap beside it. The
benchmark's runs leave it at 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, spec: dict) -> tuple:
    """(the BENCHMARK.json workload, its file, its configuration file)."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell, config = load_files(name)
    if cell["config"] != entry["config"] or cell["traffic"]["mix"] != entry["traffic"]:
        raise SystemExit(f"{name}: its file and BENCHMARK.json name other parts")
    return entry, cell, config


def load_files(name: str) -> tuple:
    """(a cell's file, its configuration's file), found by the cell's name."""
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    return cell, config


def metric_reader(name: str):
    """``perfbench/metrics/<name>.py``'s ``read``, loaded by its path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: end-to-end ones with no
    ``workloads`` or with the cell in theirs; per-layer ones likewise, for
    the end-to-end metrics the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if m["moves"] in moved
            and cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def checks_of(cell: dict, readings: dict) -> dict:
    return {k: {"value": readings[k], "limit": lim} for k, lim in cell["check"]["limits"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))

    spec = load_spec()
    entry, cell, config = load_cell(args.workload, spec)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from .cell import CellRun, per_layer, profiler_cost

    torch.cuda.set_device(0)
    out = CellRun(cell, config, args.seed, args.seconds, bool(args.trace), "cuda:0",
                  T_PROCESS, control=bool(args.control)).run()
    cost = profiler_cost(out, cell["engine"]["chunk_steps"])
    if cost:
        print("perfbench: under the profiler and outside it: " + ", ".join(
            f"{k} {v[0]} and {v[1]}" for k, v in cost.items()), file=sys.stderr)
    return report(spec, args.workload, cell, out, bool(args.trace),
                  torch.cuda.get_device_name(0), per_layer)


def report(spec, name, cell, out, trace, kind, per_layer, stream=None) -> int:
    """Print the checks to standard error and the result line; 1 without a
    result if JAX or the JAX package is loaded."""
    stream = stream or sys.stdout
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules that must not load: {bad}", file=sys.stderr)
        return 1
    wanted = metrics_of(spec, name, trace)
    if trace:
        values = per_layer(out, out.get("dims") or {}, cell, [m["name"] for m in wanted],
                           metric_reader)
    else:
        values = {m["name"]: (out["setup_s"] if m["name"] == "setup_s" else out["e2e"][m["name"]])
                  for m in wanted}
    units = {m["name"]: m["unit"] for m in wanted}
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": device}
    if trace and out.get("trace"):
        tr = out["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks_of(cell, out["readings"])
    st = out["stats"]
    print(f"perfbench: window {out['window_s']:.3f} s, {len(out['done'])} requests resolved, "
          f"engine {', '.join(f'{k} {v:.4g}' for k, v in sorted(st.items()))}", file=sys.stderr)
    r = out["readings"]
    print(f"perfbench: compared {r['requests']} requests, {r['windows']} windows, "
          f"{r['tokens']} tokens in {r['check_s']:.1f} s", file=sys.stderr)
    if "program_max_gap" in r:
        print(f"perfbench: the control in the program's place; the program's own max_gap "
              f"{r['program_max_gap']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), file=stream, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
