import io
import json

from perfbench import run as R
from perfbench import families
from perfbench.cell import per_layer

SPEC = R.load_spec()
CONF = R.load_files("large-v3-turbo.batch-int8")[1]
DIMS = families.of(CONF).dims(CONF)


def fake_out(cell):
    return {"correct": True, "attempted": 10, "failed": 0, "memory_peak_bytes": 123,
            "setup_s": 12.5, "e2e": {"audio_s_per_s": 200.0},
            "window_s": 2.0, "stats": {"admit_s": 0.5, "chunk_s": 1.0, "pull_s": 0.1,
                                       "rounds": 4, "windows": 3},
            "launches": {}, "done": [], "dims": DIMS,
            "host": {"window_s": 1.0, "done": [], "encode_windows": 5,
                     "stats": {"admit_s": 0.25, "chunk_s": 0.5, "pull_s": 0.1, "rounds": 2}},
            "trace": {"window_s": 1.0, "busy_s": 0.25, "n_kernels": 9, "kernel_s": {}, "kernel_n": {},
                      "device_ops": [["k", 0.1]], "idle_gaps": [["aten::mm", 0.05]],
                      "stats": {"admit_s": 0.1, "chunk_s": 0.2, "pull_s": 0.0, "rounds": 1},
                      "launches": {}, "encode_windows": 0, "encode_buckets": 0},
            "readings": {"max_gap": 0.01, "seek_errors": 0, "language_errors": 0,
                         "unanswered": 0, "requests": 2, "windows": 3, "tokens": 40,
                         "check_s": 0.1}}


def line(name, trace):
    _e, cell, _c = R.load_cell(name, SPEC)
    buf = io.StringIO()
    assert R.report(SPEC, name, cell, fake_out(cell), trace, "NVIDIA H100 80GB HBM3",
                    per_layer, stream=buf) == 0
    return json.loads(buf.getvalue().splitlines()[-1])


def test_end_to_end_line_keys_and_checks_last():
    res = line("large-v3.batch-int8", False)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert res["metrics"]["audio_s_per_s"] == {"value": 200.0, "unit": "audio_s/s"}
    assert res["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                             "memory_peak_bytes": 123}
    assert res["checks"]["max_gap"]["value"] == 0.01 and "limit" in res["checks"]["max_gap"]


def test_traced_line_has_per_layer_metrics_device_times_and_breakdown():
    res = line("large-v3-turbo.batch-int8", True)
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert res["device"]["busy_s"] == 0.25 and res["device"]["window_s"] == 1.0
    assert res["metrics"]["admit_share.batch"]["value"] == 25.0
    assert res["metrics"]["idle_share.batch"]["value"] == 75.0
    assert "k1_roofline.batch" not in res["metrics"]  # nothing encoded in the trace
    assert res["breakdown"] == {"device_ops": [["k", 0.1]], "idle_gaps": [["aten::mm", 0.05]]}
