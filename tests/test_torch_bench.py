"""The port's throughput benchmark and its memory guard, held to the JAX
package on the CPU: ``serving_hbm_estimate`` equal to JAX's integer for
integer, ``check_serving_hbm`` fitting or refusing as JAX's does at the same
explicit budget (the grid of tests/test_hbm_budget.py), ``run_benchmark``
refusing an oversized configuration before it allocates anything, one run on
a micro checkpoint on the CPU with bench.py's keys, and the entry point's
reading of bench.py's knobs."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from whisper_tpu import config as jax_config
from whisper_tpu.errors import HbmBudgetError as JaxHbmBudgetError
from whisper_tpu_torch import config
from whisper_tpu_torch.errors import HbmBudgetError, WhisperError
from whisper_tpu_torch.utils import benchmark

from fixtures import micro_config, write_synthetic_ggml
from test_hbm_budget import MEASURED, V5E_BUDGET

ROOT = Path(__file__).resolve().parents[1]
IDS = [m[0] for m in MEASURED]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's torch work: the suite runs in
    several worker processes at once, and torch's default of one thread a
    core in each of them oversubscribes the cores (its spinning thread pool
    then slows these decode loops tens of times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("what,kwargs,fits", MEASURED, ids=IDS)
def test_serving_hbm_estimate_equals_jax(what, kwargs, fits):
    """Every term, for every preset, at each measured configuration of the
    grid and at f32 activations."""
    for name, cfg in config.PRESETS.items():
        ref = jax_config.PRESETS[name]
        for dtype_bytes in (2, 4):
            got = cfg.serving_hbm_estimate(dtype_bytes=dtype_bytes, **kwargs)
            assert got == ref.serving_hbm_estimate(dtype_bytes=dtype_bytes, **kwargs), name


@pytest.mark.parametrize("what,kwargs,fits", MEASURED, ids=IDS)
def test_check_serving_hbm_fits_or_refuses_as_jax(what, kwargs, fits):
    """At the JAX package's budget and at budgets just below and above the
    estimate, the port fits or refuses exactly when JAX's does."""
    cfg, ref = config.PRESETS["large-v3"], jax_config.PRESETS["large-v3"]
    total = ref.serving_hbm_estimate(**kwargs)["total"]
    for budget in (V5E_BUDGET, total - 1, total):
        try:
            jax_config.check_serving_hbm(ref, budget_bytes=budget, what=what, **kwargs)
            jax_fits = True
        except JaxHbmBudgetError:
            jax_fits = False
        if jax_fits:
            est = config.check_serving_hbm(cfg, budget_bytes=budget, what=what, **kwargs)
            assert est["total"] == total and est["budget"] == budget
        else:
            with pytest.raises(HbmBudgetError) as ei:
                config.check_serving_hbm(cfg, budget_bytes=budget, what=what, **kwargs)
            assert ei.value.estimate["total"] == total > budget
            assert isinstance(ei.value, WhisperError)  # the CLI catches the base
    assert (total <= V5E_BUDGET) == fits


def test_check_serving_hbm_budget_source(monkeypatch):
    """On the CPU without budget_bytes nothing is checked and the result
    says so; on a CUDA device the budget is the card's, and without a card
    it raises: no default size."""
    cfg = config.PRESETS["large-v3"]
    est = config.check_serving_hbm(cfg, 4096, ctx=75, device="cpu")
    assert est["budget"] is None and est["total"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(WhisperError, match="no CUDA card"):
        config.check_serving_hbm(cfg, 1, ctx=75, device="cuda")
    card = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (card // 2, card))
    est = config.check_serving_hbm(cfg, 64, ctx=75, kv_dtype_bytes=1, device="cuda:0")
    assert est["budget"] == int(card * config.CARD_MEMORY_FRACTION)
    with pytest.raises(HbmBudgetError):
        config.check_serving_hbm(cfg, 4096, ctx=75, device="cuda:0")


def test_run_benchmark_refuses_oversized(monkeypatch):
    """The JAX package's measured crash configuration (beam b56) is refused
    at its budget before any weight is drawn or read; a fitting one at the
    same budget passes the guard and reaches the allocation."""
    def allocate(*args, **kwargs):
        raise RuntimeError("allocated")

    monkeypatch.setattr(benchmark, "random_model", allocate)
    monkeypatch.setattr(benchmark, "load_model", allocate)
    with pytest.raises(HbmBudgetError):
        benchmark.run_benchmark(model_name="large-v3", batch=56, beam_size=5, seconds=1,
                                device="cpu", budget_bytes=V5E_BUDGET)
    with pytest.raises(RuntimeError, match="allocated"):
        benchmark.run_benchmark(model_name="large-v3", batch=48, beam_size=5, seconds=1,
                                device="cpu", budget_bytes=V5E_BUDGET)


def test_run_benchmark_micro_on_cpu(tmp_path):
    path = str(tmp_path / "micro.bin")
    write_synthetic_ggml(path, micro_config(), seed=3)
    out = benchmark.run_benchmark(model_path=path, batch=2, seconds=1, decode_tokens=8,
                                  device="cpu")
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "rtf_torch_unknown_b2_greedy8_kvint8_wint8_eint8"
    assert out["unit"] == "audio_sec/sec/chip" and out["vs_baseline"] is None
    d = out["detail"]
    assert d["iters"] >= 1 and out["value"] == pytest.approx(d["iters"] * 2 * 30 / d["wall_s"])
    assert d["device"] == "cpu" and d["card"] is None and d["nvidia_smi"] is None
    assert d["torch"] == torch.__version__ and d["warmup_s"] > 0
    assert d["hbm_estimate"]["budget"] is None
    assert d["hbm_estimate"]["total"] == micro_config().serving_hbm_estimate(
        batch=2, ctx=1 + 8 + 8, kv_dtype_bytes=1)["total"]
    json.dumps(out)  # one JSON line


def test_run_benchmark_without_card_or_with_aot(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(WhisperError, match="CUDA card"):
        benchmark.run_benchmark(model_name="tiny", seconds=1)
    with pytest.raises(WhisperError, match="torch export"):
        benchmark.run_benchmark(model_name="tiny", seconds=1, device="cpu",
                                aot_path="serving.aot")


@pytest.mark.parametrize("env,want", [
    ({}, dict(model_name="large-v3", batch=64, beam_size=None, seconds=120,
              dtype="bfloat16", kv_dtype="int8", weight_dtype="int8", enc_dtype="int8")),
    ({"BENCH_BEAM": "5"}, dict(batch=48, beam_size=5)),
    ({"BENCH_MODEL": "medium", "BENCH_BATCH": "32", "BENCH_KV": "bfloat16",
      "BENCH_WQ": "bfloat16", "BENCH_ENC": "bfloat16", "BENCH_DTYPE": "float32",
      "BENCH_SECONDS": "15"},
     dict(model_name="medium", batch=32, kv_dtype="bfloat16", weight_dtype="bfloat16",
          enc_dtype="bfloat16", dtype="float32", seconds=15)),
], ids=["defaults", "beam", "knobs"])
def test_env_knobs_give_bench_py_defaults(env, want):
    got = benchmark.bench_config_from_env(env)
    assert {k: got[k] for k in want} == want


def test_bench_beam_engine_defaults_and_what_still_fails():
    """BENCH_MODE=engine with BENCH_BEAM=5 takes bench.py's beam engine
    defaults (32 groups, chunks of 16) and leaves the greedy defaults
    without it; spec and BENCH_DRAFT still exit naming item 14, the entry
    point with one JSON line and exit code 1."""
    got = benchmark.engine_config_from_env({"BENCH_BEAM": "5"})
    assert (got["beam_size"], got["n_slots"], got["chunk_steps"]) == (5, 32, 16)
    got = benchmark.engine_config_from_env({"BENCH_BEAM": "5", "BENCH_BATCH": "8",
                                            "BENCH_CHUNK": "4"})
    assert (got["beam_size"], got["n_slots"], got["chunk_steps"]) == (5, 8, 4)
    got = benchmark.engine_config_from_env({})
    assert (got["beam_size"], got["n_slots"], got["chunk_steps"]) == (None, 64, 32)
    with pytest.raises(WhisperError, match="parallel/spec_engine.py"):
        benchmark.bench_config_from_env({"BENCH_MODE": "spec"})
    with pytest.raises(WhisperError, match="item 14"):
        benchmark.engine_config_from_env({"BENCH_DRAFT": "d.npz"})
    env = dict(os.environ, BENCH_MODE="engine", BENCH_BEAM="5", BENCH_DRAFT="d.npz")
    proc = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.utils.benchmark",
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] == 0.0 and "parallel/spec_engine.py" in line["detail"]["error"]
    assert "item 14" in line["detail"]["error"]


def test_beam_engine_benchmark_on_a_tiny_model():
    """run_engine_benchmark with a beam on the CPU (tiny preset, two groups
    of two rows, three int16 streams, one timed wave): the beam metric name
    in JAX's order, every stream drained, the fork counts of the timed
    wave, and the memory guard's estimate at beam 2."""
    r = benchmark.run_engine_benchmark(model_name="tiny", n_slots=2, n_streams=3,
                                       chunk_steps=8, max_new_tokens=6, seconds=0,
                                       beam_size=2, device="cpu")
    assert r["metric"] == "rtf_torch_tiny_engine_s2_q3_beam2_int8"
    d = r["detail"]
    assert d["beam_size"] == 2 and d["waves"] == 1 and d["n_results"] == 3
    assert d["forks"]["rows"] == 6 and d["forks"]["steps"] > 0
    assert d["forks"]["max_forked_rows"] <= 2  # one fork a group at k = 2, trash none
    # the pool: the 32-token prompt bucket, 6 tokens and 8 spare
    assert d["hbm_estimate"] == dict(config.PRESETS["tiny"].serving_hbm_estimate(
        batch=3, beam=2, ctx=32 + 6 + 8, kv_dtype_bytes=1, enc_batch=16, engine=True),
        budget=None)
