"""Model families. The Whisper tree drawn through its family is the one the
benchmark has always drawn: its bytes at Whisper tiny and one seed, in bf16
(the served dtype) and float32, hashed leaf by leaf in the sorted order of
their paths. A second family, a stand-in kept here, runs a cell whole on
the CPU through ``CellRun`` with nothing of the harness edited, and its
own comparison decides ``correct``."""

import hashlib
import io
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import families
from perfbench import run as R
from perfbench.cell import CellRun, count_installs, per_layer, profiler_cost
from perfbench.tests.rehearsal import SEED, TINY, small_cell

STANDIN = Path(__file__).resolve().parent / "families"

# sha256 of the tree that weights.draw(TINY, SEED, dtype, "cpu") gave before
# the harness took model families
TREE_SHA256 = {
    torch.bfloat16: "854287ebc1d28687cc3cdd0a001049b56f2d171b8485c321eb21e44befbb2925",
    torch.float32: "c96df60bd5bcff851e94f19d71f34eabc3ff3ce2f772ad5b2d72b82f0d15ed17",
}


def digest(tree: dict) -> str:
    h = hashlib.sha256()

    def walk(t: dict, path: str) -> None:
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(v, path + k + "/")
                continue
            x = v.detach().cpu().contiguous()
            h.update(f"{path}{k}:{tuple(x.shape)}:{x.dtype}".encode())
            h.update(x.view(torch.int16 if x.element_size() == 2 else torch.int32)
                     .numpy().tobytes())

    walk(tree, "")
    return h.hexdigest()


@pytest.mark.parametrize("dtype", list(TREE_SHA256), ids=["bf16", "f32"])
def test_the_whisper_tree_is_drawn_as_before(dtype):
    family = families.of({"name": "no family key"})
    assert family.__file__ == str(families.DIR / "whisper.py")
    assert digest(family.draw(TINY, SEED, dtype, "cpu")) == TREE_SHA256[dtype]


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(families, "DIR", STANDIN)


def standin_cell() -> tuple:
    """BENCHMARK.json, turbo's cell shrunk as the rehearsals shrink it and
    held to the stand-in's limit, and a configuration of Whisper tiny's
    published keys that names the stand-in family."""
    spec, cell, _config = small_cell("large-v3-turbo.batch-int8")
    cell["check"]["limits"] = {"served_errors": 0, "unanswered": 0}
    config = {"name": "standin-tiny", "family": "standin",
              "published": {"d_model": 384, "encoder_layers": 4, "decoder_layers": 4,
                            "encoder_attention_heads": 6, "decoder_attention_heads": 6,
                            "encoder_ffn_dim": 1536, "decoder_ffn_dim": 1536,
                            "num_mel_bins": 80, "vocab_size": 51865,
                            "max_source_positions": 1500, "max_target_positions": 448}}
    return spec, cell, config


def test_a_second_family_runs_a_cell_whole_and_its_readings_decide_correct(standin):
    torch.set_num_threads(2)
    spec, cell, config = standin_cell()
    run = CellRun(cell, config, SEED, 8.0, False, "cpu", time.perf_counter())
    assert run.dims == TINY
    out = run.run()
    r = out["readings"]
    assert out["correct"], r
    assert "max_gap" not in r and r["served_errors"] == 0 and r["tokens"] > 0
    buf = io.StringIO()
    assert R.report(spec, "standin-tiny.batch", cell, out, False, "cpu", per_layer,
                    stream=buf) == 0
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert line["correct"] and set(line["checks"]) == {"served_errors", "unanswered"}
    # the same run judged again under a limit that its readings exceed
    run.cell["check"]["limits"]["served_errors"] = -1
    run._check()
    assert out["correct"] is False and out["readings"]["served_errors"] == 0


def test_an_unknown_family_names_the_missing_file(standin):
    _spec, cell, config = standin_cell()
    with pytest.raises(FileNotFoundError, match=r"nosuch\.py"):
        CellRun(cell, dict(config, family="nosuch"), SEED, 8.0, False, "cpu", 0.0)
    with pytest.raises(ValueError):
        families.load("../whisper")


def test_an_engine_without_buckets_or_totals_reads_nothing():
    assert count_installs(object()) == []
    out = {"trace": {"stats": {"rounds": 2}, "encode_windows": 3},
           "host": {"stats": {"rounds": 2, "chunk_s": 1.0}, "encode_windows": 3}}
    assert profiler_cost(out, 32) == {"step_ms": (None, None),
                                      "admit_ms_a_window": (None, None)}
