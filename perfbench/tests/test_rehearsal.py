"""Each cell's code path run whole at a tiny size on the CPU through the
internal entry: traffic, warm-up, window, trace, the comparison and the
result line. (The command itself refuses to run without a card.)"""

import io
import json

import pytest

from perfbench import run as R
from perfbench.cell import per_layer, profiler_cost
from perfbench.tests.rehearsal import rehearse

CELLS = [w["name"] for w in R.load_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_whole_and_its_output_is_correct(name):
    spec, cell, out = rehearse(name, seconds=8.0, trace=True)
    assert out["correct"], out["readings"]
    r = out["readings"]
    assert r["requests"] >= 1 and r["tokens"] > 0 and r["windows"] >= 1
    assert out["attempted"] >= 1 and out["failed"] == 0
    buf = io.StringIO()
    assert R.report(spec, name, cell, out, True, "cpu", per_layer, stream=buf) == 0
    res = json.loads(buf.getvalue().splitlines()[-1])
    assert res["correct"] and list(res)[-1] == "checks"
    # the CPU has no device trace: no roofline, no idle share; host numbers read
    assert not any("roofline" in k or "idle_share" in k for k in res["metrics"])
    assert {"step_ms.batch", "admit_share.batch"} <= set(res["metrics"]), res["metrics"]
    e2e = {m["name"] for m in R.metrics_of(spec, name, False)} - {"setup_s"}
    assert set(out["e2e"]) >= e2e and all(out["e2e"][k] > 0 for k in e2e)
    # the windows each bucket held were counted, and the profiler's cost reads
    assert out["trace"]["encode_buckets"] >= 0 and out["host"]["encode_windows"] > 0
    assert profiler_cost(out, cell["engine"]["chunk_steps"])["step_ms"][1] > 0

