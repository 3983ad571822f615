"""The comparison fails what it must: the control (the reference at int4
and an int8 encoder in the program's place) comes out not correct, and so
does a run whose timed path is broken underneath: a token altered where the
engine produces it, and a decode step that leaves the slot pool's self keys
and values unchanged."""

import pytest

from perfbench import run as R
from perfbench.tests.rehearsal import WIDE, rehearse

CELLS = [w["name"] for w in R.load_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_and_the_program_is(name):
    _spec, cell, out = rehearse(name, seconds=30.0, control=True, dims=WIDE)
    r = out["readings"]
    assert out["correct"] is False, r
    assert r["max_gap"] > cell["check"]["limits"]["max_gap"] >= r["program_max_gap"], r


def _alter_a_token(monkeypatch):
    from whisper_tpu_torch.parallel.engine import SlotEngine

    real = SlotEngine._stream_result

    def altered(self, s, pulled):
        res = real(self, s, pulled)
        if len(res.tokens) > 1:  # the first text token, swapped for its neighbour
            res.tokens = [res.tokens[0], res.tokens[1] + 1] + res.tokens[2:]
        return res

    monkeypatch.setattr(SlotEngine, "_stream_result", altered)


def _freeze_the_pool(monkeypatch):
    import whisper_tpu_torch.model.decoder as decoder

    monkeypatch.setattr(decoder, "_append_rows", lambda *a, **k: None)


@pytest.mark.parametrize("fault", [_alter_a_token, _freeze_the_pool],
                         ids=["token-altered", "state-unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    _spec, _cell, out = rehearse(name, seconds=8.0)
    assert not out["correct"], out["readings"]
