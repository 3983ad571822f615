"""The SlotEngine's decode step as one captured CUDA graph
(``whisper_tpu_torch.parallel.engine``), on the CPU: every state tensor and
rule mask keeps its storage through chunks, refills and option changes
(a graph reads fixed addresses), a refill is what the next step reads, and,
with a stand-in for the graph's home that records the step and replays it by
calling it, the engine's tokens are the eager engine's, every step after a
key's capture is a replay, the rule options and a rebuilt pool recapture,
and the kernels' launch counters count the captured launches at each
replay."""

import dataclasses

import numpy as np
import pytest
import torch

from whisper_tpu_torch.decoding.task import DecodingOptions
from whisper_tpu_torch.kernels.launches import add_launches, kernel_launches
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.model.quant import QuantKV, quantize_decoder_weights
from whisper_tpu_torch.parallel import engine as engine_mod
from whisper_tpu_torch.parallel.engine import SCHEDULES, SlotEngine
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions

from fixtures import micro_config, synthetic_audio, write_synthetic_ggml

OPTS = DecodingOptions(sample_len=24)
CAPTURED = {"k4_ragged": 7, "k5": 3}  # what the stand-in's capture "launches"


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's torch work (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("graph") / "micro.bin"
    write_synthetic_ggml(str(path), micro_config(), seed=9)
    base = load_model(str(path), device="cpu", use_native=False)
    return {False: base, True: base.with_params(quantize_decoder_weights(base.params))}


def _audios(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(16000 + 4000 * i).astype(np.float32) * 0.3 for i in range(n)]


class _Graph:
    """A captured step: its replay calls the body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _Home:
    """A stand-in for ``engine._GraphHome`` on the CPU: the warm-up runs the
    body, the capture runs nothing and counts the launches in ``CAPTURED``
    as the kernel wrappers count theirs while a graph is captured."""

    def __init__(self, device):
        self.captures = self.releases = 0

    def release(self):
        self.releases += 1

    def warm_up(self, body):
        body()

    def capture(self, body):
        self.captures += 1
        add_launches(CAPTURED)
        return _Graph(body)


@pytest.fixture
def graphs(monkeypatch):
    monkeypatch.setattr(engine_mod, "_graph_home", _Home)


def _tensors(eng) -> dict:
    """Every state tensor (each leaf of an int8 pool), the cross pools' and
    the rule masks, by name."""
    out = {}
    for f in dataclasses.fields(eng._state):
        v = getattr(eng._state, f.name)
        for i, leaf in enumerate(v if isinstance(v, QuantKV) else (v,)):
            out[f"{f.name}.{i}"] = leaf
    for name in ("_cross_pool_k", "_cross_pool_v"):
        pool = getattr(eng, name)
        for i, leaf in enumerate(pool if isinstance(pool, QuantKV) else (pool,)):
            out[f"{name}.{i}"] = leaf
    out["sup_mask"], out["blank_mask"] = eng.sup_mask, eng.blank_mask
    return out


def _ptrs(eng) -> dict:
    return {k: t.data_ptr() for k, t in _tensors(eng).items()}


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_state_and_masks_keep_their_storage(models, quantize):
    """Chunks, refills, a stream run's option masks and a later
    transcribe_many write into the same tensors."""
    eng = SlotEngine(models[quantize], n_slots=2, options=OPTS, chunk_steps=4,
                     quantize=quantize, schedule="overlapped")
    masks = (eng.sup_mask.data_ptr(), eng.blank_mask.data_ptr())
    # a stream run first: it sizes the pool for prompts
    eng.transcribe_streams([synthetic_audio(16000 * 3, seed=2)],
                           TranscribeOptions(temperature=0.0, suppress_tokens=[],
                                             without_timestamps=True))
    before = _ptrs(eng)
    assert (before["sup_mask"], before["blank_mask"]) == masks
    assert not eng.sup_mask.any()
    eng.transcribe_many(_audios(3, seed=1))
    assert _ptrs(eng) == before
    eng.transcribe_streams([synthetic_audio(16000 * 3, seed=3)], TranscribeOptions(temperature=0.0))
    assert _ptrs(eng) == before
    eng.transcribe_many(_audios(3, seed=3))
    assert _ptrs(eng) == before
    # the constructor's masks again, in the same buffers
    assert torch.equal(eng.sup_mask, eng._option_masks[0])
    assert torch.equal(eng.blank_mask, eng._option_masks[1])


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_the_next_step_reads_what_a_refill_wrote(models, quantize):
    """A refill's logits, written in place, decide the next step's token,
    and the step leaves every tensor where it was."""
    eng = SlotEngine(models[quantize], n_slots=2, options=OPTS, chunk_steps=4,
                     quantize=quantize)
    eng.transcribe_many(_audios(2, seed=4))
    st, before = eng._state, _ptrs(eng)
    staged = eng._encode_bucket(eng._window_batch(_audios(1, seed=5), 1), 1)
    eot = eng.vocab.token_eot
    want = next(t for t in range(eot) if not (eng.sup_mask[t] or eng.blank_mask[t]))
    staged["logits"] = torch.full_like(staged["logits"], -5.0)
    staged["logits"][0, want] = 50.0
    eng._install_rows(staged, [1], [0])
    assert bool(st.active[1]) and int(st.step[1]) == 0
    n_past = int(st.n_past[1])
    with torch.inference_mode():
        engine_mod._decode_step(eng.model.decoder, st, eng._cross_pool_k, eng._cross_pool_v,
                                eng.sup_mask, eng.blank_mask, False, None)
    assert int(st.tokens_out[1, 0]) == want and int(st.last_tok[1]) == want
    assert int(st.step[1]) == 1 and int(st.n_past[1]) == n_past + 1
    assert _ptrs(eng) == before


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_replayed_steps_give_the_eager_tokens(models, quantize, sched, monkeypatch):
    """Under the stand-in every step after the first is a replay, the tokens
    and log-probabilities are the eager engine's, and each replay adds the
    capture's launches to the counters (the capture's own are taken back)."""
    audios = _audios(5, seed=6)
    ref = SlotEngine(models[quantize], n_slots=2, options=OPTS, chunk_steps=4, quantize=quantize,
                     schedule=sched).transcribe_many(audios)
    monkeypatch.setattr(engine_mod, "_graph_home", _Home)
    eng = SlotEngine(models[quantize], n_slots=2, options=OPTS, chunk_steps=4, quantize=quantize,
                     schedule=sched)
    n0 = kernel_launches()
    got = eng.transcribe_many(audios)
    n = {k: v - n0[k] for k, v in kernel_launches().items()}
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert [r.avg_logprob for r in got] == [r.avg_logprob for r in ref]
    st = eng.stats
    assert st["graph_captures"] == 1 and eng._home.captures == 1
    assert st["graph_steps"] == st["decode_steps"] - 1 > 0
    # the CPU's kernels are plain versions and count nothing themselves
    assert n == {k: (CAPTURED.get(k, 0) * st["graph_steps"]) for k in n}


def test_rule_options_and_a_rebuilt_pool_recapture(models, graphs):
    """A graph is kept per (use_timestamps, max_initial_index) on a pool:
    the constructor's options and a stream run's are two captures, a second
    run of either replays only, and a rebuilt pool captures anew and drops
    the old pool's graphs."""
    opts = dataclasses.replace(OPTS, max_initial_timestamp=0.5)
    eng = SlotEngine(models[True], n_slots=2, options=opts, chunk_steps=4, quantize=True)
    audios = _audios(3, seed=7)
    clip = synthetic_audio(16000 * 3, seed=8)
    eng.transcribe_streams([clip], TranscribeOptions(temperature=0.0))
    assert eng.stats["graph_captures"] == 1 and eng.max_initial_index == 50
    eng.transcribe_streams([clip], TranscribeOptions(temperature=0.0, without_timestamps=True))
    assert eng.stats["graph_captures"] == 1 and eng.max_initial_index is None
    first = [r.tokens for r in eng.transcribe_many(audios)]
    assert eng.stats["graph_captures"] == 1 and eng.max_initial_index == 25
    assert set(eng._step_graphs) == {(True, 25), (True, 50), (False, None)}
    again = eng.transcribe_many(audios)
    assert [r.tokens for r in again] == first
    assert eng.stats["graph_captures"] == 0
    assert eng.stats["graph_steps"] == eng.stats["decode_steps"] > 0
    # a fresh pool (as the engine bench makes after its warm-up)
    old = eng._state
    eng._state = None
    eng._cross_pool_k = eng._cross_pool_v = None
    assert [r.tokens for r in eng.transcribe_many(audios)] == first
    assert eng.stats["graph_captures"] == 1 and eng._home.captures == 4
    assert eng._home.releases == 1  # the old pool's graphs went with it
    assert list(eng._step_graphs) == [(True, 25)]
    assert eng._step_graphs[(True, 25)][0][0] is eng._state is not old


def test_a_stale_pool_is_never_replayed(models, graphs):
    """A state swapped in without a rebuild is noticed by its identity: the
    step captures again instead of replaying over the old tensors."""
    eng = SlotEngine(models[False], n_slots=2, options=OPTS, chunk_steps=4)
    audios = _audios(2, seed=9)
    eng.transcribe_many(audios)
    st = eng._state
    eng._state = dataclasses.replace(st, **{
        f.name: (getattr(st, f.name).clone() if isinstance(getattr(st, f.name), torch.Tensor)
                 else getattr(st, f.name)) for f in dataclasses.fields(st)})
    eng.transcribe_many(audios)
    assert eng.stats["graph_captures"] == 1
    assert eng._step_graphs[(True, 50)][0][0] is eng._state


def test_launch_counters_read_and_add():
    n0 = kernel_launches()
    add_launches({"k4": 2, "k7": 1})
    n1 = kernel_launches()
    add_launches({"k4": -2, "k7": -1})
    assert {k: n1[k] - n0[k] for k in n0 if n1[k] != n0[k]} == {"k4": 2, "k7": 1}
    assert kernel_launches() == n0
