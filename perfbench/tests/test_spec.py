import json
import re
from pathlib import Path

import pytest

from perfbench import run as R
from perfbench import families

ROOT = Path(__file__).resolve().parents[2]
SPEC = R.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"][:3] == ["python3", "-m", "perfbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, [c["name"] for c in SPEC["configs"]],
                  [w["name"] for w in SPEC["workloads"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in names
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200


def test_every_file_is_found_by_its_name():
    for c in SPEC["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"] == []
        families.of(conf).dims(conf)
    for w in SPEC["workloads"]:
        entry, cell, conf = R.load_cell(w["name"], SPEC)
        assert cell["name"] == w["name"] and conf["name"] == w["config"]
    listed = {m["name"] for m in SPEC["per_layer"]}
    files = {p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")}
    assert files == listed
    for name in listed:
        assert callable(R.metric_reader(name))


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(w):
    e2e = {m["name"] for m in R.metrics_of(SPEC, w, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert R.metrics_of(SPEC, w, trace=True)


def test_four_chip_cells_within_a_quarter():
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def test_a_full_check_fits_the_driver_s_time():
    cells = 24
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
