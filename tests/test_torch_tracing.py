"""The port's stages and spans (``utils.logging.StageTimers``) and the serving
engine's use of them on the CPU: nesting, parents, request ids, the bounded
buffer, recording off by default; then a micro-model ``EngineServer`` with
recording on, whose spans must name every request and bucket and add up to
the engine's totals, with the counters of decode steps and admitted
windows, and ``/metrics`` printing them."""

import http.client
import threading
import time

import pytest
import torch

from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.parallel.engine import SCHEDULES, SlotEngine
from whisper_tpu_torch.parallel.server import EngineServer, make_http_server
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions
from whisper_tpu_torch.utils.logging import StageTimers

from fixtures import micro_config, synthetic_audio, write_synthetic_ggml

SR = 16000
WAIT = 300  # seconds: the bound on every wait for a result


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's torch work (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The micro checkpoint (windows of 1.28 s) with a multilingual vocab,
    so a request without a language runs language detection."""
    path = tmp_path_factory.mktemp("trace") / "ggml-micro-multi.bin"
    write_synthetic_ggml(path, micro_config(n_vocab=51865), seed=9)
    return load_model(str(path), device="cpu", use_native=False)


def test_stages_nest_record_ids_and_add_to_their_totals():
    t = StageTimers()
    t.record(True)
    with t.stage("round", None):
        with t.stage("admit", "admit_s", ids=[3, 4], size=8):
            time.sleep(0.002)
        with t.stage("mel"):
            pass
    spans = {s.name: s for s in t.drain()}
    assert set(spans) == {"round", "admit", "mel"}
    r, a, m = spans["round"], spans["admit"], spans["mel"]
    assert r.parent == -1 and a.parent == r.index and m.parent == r.index
    assert a.ids == (3, 4) and a.size == 8 and r.ids == () and r.size is None
    assert r.start_ns <= a.start_ns < a.end_ns <= m.start_ns <= m.end_ns <= r.end_ns
    # totals: under another key, under the name by default, or none
    assert set(t.totals) == {"admit_s", "mel"}
    assert t.totals["admit_s"] == pytest.approx((a.end_ns - a.start_ns) / 1e9)
    assert t.totals["admit_s"] >= 0.002
    assert t.counts == {"round": 1, "admit": 1, "mel": 1}
    assert t.drain() == []  # drained


def test_recording_is_off_by_default_and_the_buffer_is_bounded():
    t = StageTimers(maxlen=3)
    for _ in range(4):
        with t.stage("chunk", "chunk_s"):
            pass
    assert t.drain() == [] and t.counts["chunk"] == 4 and t.totals["chunk_s"] > 0
    t.count("decode_steps", 5)
    t.count("decode_steps")
    assert t.totals["decode_steps"] == 6
    t.record(True)
    for i in range(5):
        with t.stage("chunk", "chunk_s", ids=(i,)):
            pass
    t.record(False)
    with t.stage("chunk", "chunk_s"):
        pass
    kept = t.drain()
    assert [s.ids for s in kept] == [(2,), (3,), (4,)]  # the last maxlen
    assert [s.index for s in kept] == [6, 7, 8]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_transcribe_many_counts_its_buckets_and_steps(model, schedule):
    eng = SlotEngine(model, n_slots=3, chunk_steps=4, max_new_tokens=12, schedule=schedule)
    eng.spans.record(True)
    audios = [synthetic_audio(SR, seed=s) for s in range(5)]
    assert len(eng.transcribe_many(audios)) == 5
    st, spans = eng.stats, eng.spans.drain()
    buckets = [s for s in spans if s.name == "engine.admit.bucket"]
    assert sorted(i for b in buckets for i in b.ids) == list(range(5))
    assert st["encode_windows"] == 5 and st["encode_buckets"] == len(buckets)
    assert st["encode_rows"] == sum(b.size for b in buckets)
    assert 0 < st["decode_steps"] <= st["rounds"] * eng.chunk_steps
    for name, total in (("engine.chunk", "chunk_s"), ("engine.pull", "pull_s"),
                        ("engine.finish", "harvest_s")):
        assert sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e9 == \
            pytest.approx(st[total], rel=1e-6, abs=1e-9)


def _get(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    conn.request("GET", path)
    return conn.getresponse().read().decode()


def test_server_spans_name_each_request_and_add_up_to_the_totals(model):
    audios = [synthetic_audio(SR * sec, seed=sec) for sec in (1, 2, 4)]
    languages = ["en", None, "en"]  # the second detects its language
    eng = SlotEngine(model, n_slots=2, chunk_steps=4, max_new_tokens=12)
    with EngineServer(eng, TranscribeOptions(temperature=0.0)) as srv:
        eng.spans.record(True)
        futs = [srv.submit(a, language=lang) for a, lang in zip(audios, languages)]
        for f in futs:
            f.result(timeout=WAIT)
        httpd = make_http_server(srv, "127.0.0.1", 0)
        web = threading.Thread(target=httpd.serve_forever, daemon=True)
        web.start()
        try:
            metrics = _get(httpd.server_address[1], "/metrics")
        finally:
            httpd.shutdown()
            httpd.server_close()
            web.join(timeout=60)
        assert not web.is_alive()
    st, spans = dict(eng.stats), eng.spans.drain()  # the worker has stopped
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    index = {s.index: s for s in spans}

    # every admitted request: one start, at least one finished window, one
    # resolution, each under the stage the table of spans puts it in
    ids = sorted(s.ids[0] for s in by["server.start_request"])
    assert ids == [0, 1, 2] and st["requests"] == 3
    assert [s.ids for s in by["engine.detect_language"]] == [(1,)]
    assert index[by["engine.detect_language"][0].parent].name == "server.start_request"
    done = [s.ids[0] for s in by["engine.window_done"]]
    assert set(done) == {0, 1, 2} and len(done) == st["windows"] >= 3
    assert sorted(s.ids[0] for s in by["server.resolve"]) == [0, 1, 2]
    parents = {"server.ingest": "engine.round", "server.start_request": "engine.round",
               "engine.admit": "engine.round", "engine.admit.bucket": "engine.admit",
               "engine.chunk": "engine.round", "engine.pull": "engine.round",
               "engine.finish": "engine.round", "engine.window_done": "engine.finish",
               "server.resolve": "engine.window_done"}
    for name, parent in parents.items():
        assert {index[s.parent].name for s in by[name]} == {parent}, name
    assert all(s.parent == -1 for s in by["engine.round"])

    # buckets list their ids; the counters are the windows admitted
    buckets = by["engine.admit.bucket"]
    assert all(1 <= len(b.ids) <= b.size for b in buckets)
    assert st["encode_windows"] == sum(len(b.ids) for b in buckets) == st["windows"]
    assert st["encode_rows"] == sum(b.size for b in buckets)
    assert st["encode_buckets"] == len(buckets)
    assert 0 < st["decode_steps"] <= st["rounds"] * eng.chunk_steps

    # the recorded stages add up to the totals (recording began before any
    # request)
    for name, total in (("engine.admit", "admit_s"), ("engine.chunk", "chunk_s"),
                        ("engine.pull", "pull_s"), ("engine.finish", "harvest_s"),
                        ("server.start_request", "init_s")):
        got = sum(s.end_ns - s.start_ns for s in by[name]) / 1e9
        assert got == pytest.approx(st[total], rel=1e-6, abs=1e-9), name
    for key in ("init_s", "harvest_s", "ingest_s", "decode_steps", "encode_windows"):
        assert f"whisper_{key} " in metrics, key
