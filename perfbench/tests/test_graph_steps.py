"""``graph_step_share.batch``: the share of the decode steps that replayed the
program's captured step graph, read through a tiny cell's rehearsal on the
CPU with the graph's home stood in for (a capture that records the step and
a replay that calls it, as the card replays the captured one), and nothing
where the program counts no graph steps (the CPU's eager step, a program
without the counter)."""

import io
import json

from perfbench import run as R
from perfbench.cell import per_layer
from perfbench.tests.rehearsal import rehearse
from whisper_tpu_torch.parallel import engine as engine_mod

NAME = "graph_step_share.batch"


class _Graph:
    def __init__(self, body):
        self.replay = body


class _Home:
    def __init__(self, device):
        pass

    def release(self):
        pass

    def warm_up(self, body):
        body()

    def capture(self, body):
        return _Graph(body)


def test_a_rehearsed_cell_reads_every_window_step_as_a_replay(monkeypatch):
    monkeypatch.setattr(engine_mod, "_graph_home", _Home)
    name = "large-v3.batch-int8"
    spec, cell, out = rehearse(name, seconds=8.0, trace=True)
    assert out["correct"], out["readings"]
    s = out["host"]["stats"]
    assert s["decode_steps"] > 0 and s["graph_steps"] == s["decode_steps"]
    buf = io.StringIO()
    assert R.report(spec, name, cell, out, True, "cpu", per_layer, stream=buf) == 0
    metrics = json.loads(buf.getvalue().splitlines()[-1])["metrics"]
    assert metrics[NAME] == {"value": 100.0, "unit": "%"}


def test_nothing_is_read_without_graph_steps():
    read = R.metric_reader(NAME)
    assert read({"host": {"stats": {"decode_steps": 40, "chunk_s": 1.0}}}) is None
    assert read({"host": {"stats": {"decode_steps": 0, "graph_steps": 0}}}) is None
    assert read({"host": {"stats": {"decode_steps": 40, "graph_steps": 30}}}) == 75.0
