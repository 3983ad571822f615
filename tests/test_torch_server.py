"""The port's serving daemon (``whisper_tpu_torch.parallel.server``) on the
CPU, after tests/test_server.py: the host functions (``parse_multipart``,
``openai_response``, ``_latency_percentiles``) held to the JAX package's on
the same inputs, byte for byte; the queue-fed worker, the HTTP front end,
cancel, deadlines, busy 503, worker death and the fast stop held to the
port engine's own ``transcribe_streams``, greedy and beam. No JAX engine
runs here. Every wait has a bound."""

import dataclasses
import http.client
import io
import json
import threading
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from whisper_tpu.parallel import server as jax_server
from whisper_tpu_torch.decoding.task import DecodingOptions
from whisper_tpu_torch.io.wav import load_wav_bytes
from whisper_tpu_torch.model.load import load_model
from whisper_tpu_torch.parallel import server
from whisper_tpu_torch.parallel.beam_engine import BeamSlotEngine
from whisper_tpu_torch.parallel.engine import SlotEngine
from whisper_tpu_torch.parallel.server import (EngineServer, MultiEngineServer, ServerBusy,
                                               make_http_server)
from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions

from fixtures import micro_config, synthetic_audio, write_synthetic_ggml

SR = 16000
WAIT = 600  # seconds: the bound on every wait for a result


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


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The micro checkpoint: windows of 1.28 s (n_audio_ctx 64), so a few
    seconds of audio make a multi-window stream."""
    path = tmp_path_factory.mktemp("srv") / "ggml-micro-synth.bin"
    write_synthetic_ggml(path, micro_config(), seed=9)
    return load_model(str(path), device="cpu", use_native=False)


def _wav(audio) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, SR, (audio * 32767).astype(np.int16))
    return buf.getvalue()


def _heard(audio) -> np.ndarray:
    """The samples the server decodes from ``_wav(audio)``."""
    return load_wav_bytes(_wav(audio))


def _multipart(boundary: str, fields: dict) -> bytes:
    out = b""
    for name, (filename, value) in fields.items():
        out += f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'.encode()
        if filename:
            out += f'; filename="{filename}"'.encode()
        out += b"\r\n\r\n" + value + b"\r\n"
    return out + f"--{boundary}--\r\n".encode()


class _Http:
    """make_http_server on a loopback port in a thread, shut down on exit."""

    def __init__(self, srv):
        self.httpd = make_http_server(srv, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return http.client.HTTPConnection("127.0.0.1", self.httpd.server_address[1],
                                          timeout=WAIT)

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


def _tokens(result):
    return [s["tokens"] for s in result["segments"]]


# -- the host functions, held to the JAX package's --

MULTIPART_CASES = {
    "file-and-field": ("XbOuNdArYx", (
        '--XbOuNdArYx\r\nContent-Disposition: form-data; name="file"; filename="a.wav"\r\n'
        "Content-Type: audio/wav\r\n\r\n").encode() + b"RIFF\x00raw\r\nbytes" + (
        '\r\n--XbOuNdArYx\r\nContent-Disposition: form-data; name="language"\r\n\r\n'
        "en\r\n--XbOuNdArYx--\r\n").encode()),
    # a binary payload ending in CR/LF: only the delimiter's CRLF goes
    "trailing-crlf": ("XbOuNdArYx", b'--XbOuNdArYx\r\nContent-Disposition: form-data; '
                      b'name="file"\r\n\r\nRIFFdata\x00\r\n\r\n--XbOuNdArYx--\r\n'),
    # RFC 7578 does not order the parameters: filename before name
    "filename-first": ('"XbOuNdArYx"', (
        '--XbOuNdArYx\r\nContent-Disposition: form-data; filename="a.wav"; name="file"\r\n'
        "Content-Type: audio/wav\r\n\r\n").encode() + b"RIFFdata\r\n--XbOuNdArYx--\r\n"),
}


@pytest.mark.parametrize("case", sorted(MULTIPART_CASES))
def test_parse_multipart_equals_jax(case):
    boundary, body = MULTIPART_CASES[case]
    ctype = f"multipart/form-data; boundary={boundary}"
    got = server.parse_multipart(body, ctype)
    assert got == jax_server.parse_multipart(body, ctype) and "file" in got
    if case == "trailing-crlf":
        assert got["file"] == b"RIFFdata\x00\r\n"
    for bad in ("multipart/form-data", "multipart/form-data; charset=utf-8"):
        with pytest.raises(ValueError):
            server.parse_multipart(body, bad)
        with pytest.raises(ValueError):
            jax_server.parse_multipart(body, bad)


RESULT = {
    "text": " hello wörld, again", "language": "en", "duration": 3.5,
    "segments": [
        {"id": 0, "seek": 0, "t0": 0.0, "t1": 2.5, "text": " hello wörld,", "tokens": [1, 2],
         "temperature": 0.0, "avg_logprob": -0.1, "compression_ratio": 0.9,
         "no_speech_prob": 0.01, "token_data": None, "words": None},
        {"id": 1, "seek": 250, "t0": 2.5, "t1": 3604.25, "text": " again", "tokens": [3],
         "temperature": 0.2, "avg_logprob": -0.3, "compression_ratio": 1.1,
         "no_speech_prob": 0.2, "token_data": None,
         "words": [{"word": " again", "start": 2.5, "end": 3.0, "probability": 0.5}]},
    ],
}


@pytest.mark.parametrize("fmt", ["json", "text", "verbose_json", "srt", "vtt"])
@pytest.mark.parametrize("task", ["transcribe", "translate"])
def test_openai_response_equals_jax(fmt, task):
    got = server.openai_response(RESULT, fmt, task=task)
    assert got == jax_server.openai_response(RESULT, fmt, task=task)
    assert got[0].encode("utf-8") == jax_server.openai_response(RESULT, fmt, task=task)[
        0].encode("utf-8")
    with pytest.raises(ValueError):
        server.openai_response(RESULT, "flac")


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000])
def test_latency_percentiles_equal_jax(n):
    rng = np.random.default_rng(n)
    lats = [(float(w), float(w + t)) for w, t in rng.random((n, 2)) * 3]
    assert server._latency_percentiles(lats) == jax_server._latency_percentiles(lats)


# -- the worker and the HTTP front end over port engines --

def test_engine_server_matches_transcribe_streams(model):
    """Concurrent submits through the queue-fed worker give exactly the
    engine's transcribe_streams results."""
    audios = [synthetic_audio(SR * 5, seed=1), synthetic_audio(SR * 2, seed=3),
              synthetic_audio(SR * 3, seed=5)]
    topts = TranscribeOptions(temperature=0.0, condition_on_previous_text=True)
    ref = SlotEngine(model, n_slots=2, chunk_steps=8).transcribe_streams(audios, topts)
    engine = SlotEngine(model, n_slots=2, chunk_steps=8)
    with EngineServer(engine, topts) as srv:
        got = [f.result(timeout=WAIT) for f in [srv.submit(a) for a in audios]]
    assert engine.stats["requests"] == 3
    for r, g in zip(ref, got):
        assert (g["text"], g["duration"], _tokens(g)) == (r["text"], r["duration"], _tokens(r))


def test_engine_server_beam_groups(model):
    """The worker drives a BeamSlotEngine (cli serve --beam): results equal
    the beam engine's own transcribe_streams."""
    audios = [synthetic_audio(SR * 5, seed=1), synthetic_audio(SR * 2, seed=4)]
    topts = TranscribeOptions(temperature=0.0, beam_size=2, condition_on_previous_text=True,
                              use_device_loop=True)

    def engine():
        return BeamSlotEngine(model, n_slots=2, chunk_steps=8,
                              options=DecodingOptions(beam_size=2))

    ref = engine().transcribe_streams(audios, topts)
    with EngineServer(engine(), topts) as srv:
        got = [f.result(timeout=WAIT) for f in [srv.submit(a) for a in audios]]
    for r, g in zip(ref, got):
        assert (g["text"], _tokens(g)) == (r["text"], _tokens(r))


def test_engine_server_http_roundtrip(model):
    """POST /transcribe, ?stream=1 (segments as they finalize, then a
    summary) and /v1/audio/transcriptions give the engine's own results;
    /healthz, /stats and /metrics respond; malformed bodies get 400."""
    audio, long_audio = synthetic_audio(SR * 2, seed=2), synthetic_audio(SR * 5, seed=7)
    topts = TranscribeOptions(temperature=0.0)
    ref, ref_long = SlotEngine(model, n_slots=2, chunk_steps=8).transcribe_streams(
        [_heard(audio), _heard(long_audio)], topts)
    boundary = "XtEsTbOuNdX"
    hdrs = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    with EngineServer(SlotEngine(model, n_slots=2, chunk_steps=8), topts) as srv, \
            _Http(srv) as conn:
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["ok"] is True

        conn.request("POST", "/transcribe", body=_wav(audio),
                     headers={"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        assert resp.status == 200
        result = json.loads(resp.read())
        assert result["duration"] == pytest.approx(2.0, abs=0.01)
        assert (result["text"], _tokens(result)) == (ref["text"], _tokens(ref))

        conn.request("POST", "/transcribe", body=b"not a wav")
        assert conn.getresponse().status == 400

        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests"] >= 1
        lat = stats["latency"]
        assert lat["n"] >= 1 and 0 <= lat["queue_wait_mean_s"] <= lat["total_p99_s"]

        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.getheader("Content-Type").startswith("text/plain")
        body = resp.read().decode()
        assert "whisper_requests 1" in body
        assert 'whisper_request_latency_seconds{quantile="0.5"}' in body

        conn.request("POST", "/transcribe?stream=1", body=_wav(long_audio))
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        first = json.loads(resp.readline())
        assert "segment" in first  # arrived before the summary line
        rest = [json.loads(ln) for ln in resp.read().splitlines()]
        segs = [first["segment"]] + [ln["segment"] for ln in rest[:-1]]
        assert rest[-1]["done"] is True and rest[-1]["text"] == ref_long["text"]
        assert rest[-1]["duration"] == pytest.approx(5.0, abs=0.01)
        assert [s["tokens"] for s in segs] == _tokens(ref_long) and len(segs) >= 2
        conn.close()

        conn.request("POST", "/v1/audio/transcriptions", headers=hdrs, body=_multipart(
            boundary, {"file": ("a.wav", _wav(audio)),
                       "response_format": (None, b"verbose_json"), "language": (None, b"en")}))
        resp = conn.getresponse()
        assert resp.status == 200
        v = json.loads(resp.read())
        assert v["language"] == "en" and v["text"] == ref["text"]
        assert [s["tokens"] for s in v["segments"]] == _tokens(ref)

        conn.request("POST", "/v1/audio/transcriptions", headers=hdrs, body=_multipart(
            boundary, {"file": ("a.wav", _wav(audio)), "response_format": (None, b"srt")}))
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.read().decode() == server.openai_response(ref, "srt")[0]

        conn.request("POST", "/v1/audio/transcriptions", headers=hdrs,
                     body=_multipart(boundary, {"response_format": (None, b"json")}))
        assert conn.getresponse().status == 400  # no file field
        conn.close()


def test_engine_server_worker_death_fails_futures(model):
    """A fatal engine error fails every outstanding future, makes later
    submits raise, and turns /healthz to 503."""
    engine = SlotEngine(model, n_slots=2, chunk_steps=8)
    srv = EngineServer(engine, TranscribeOptions(temperature=0.0)).start()

    def boom(*a, **k):
        raise RuntimeError("card fell over")

    engine._admit_stream_windows = boom
    try:
        with _Http(srv) as conn:
            fut = srv.submit(synthetic_audio(SR * 2, seed=2))
            with pytest.raises(RuntimeError, match="card fell over"):
                fut.result(timeout=WAIT)
            srv._thread.join(timeout=WAIT)  # the worker exits after the fatal error
            assert not srv._thread.is_alive()
            with pytest.raises(RuntimeError, match="not running"):
                srv.submit(synthetic_audio(SR * 2, seed=2))
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.status == 503 and json.loads(resp.read())["ok"] is False
            conn.close()
    finally:
        srv.stop()


def test_engine_server_busy_503(model):
    """max_queue backpressure: an excess submit raises ServerBusy, HTTP maps
    it to 503 with Retry-After; an oversized body gets 413 unread."""
    audio = synthetic_audio(SR * 2, seed=2)
    with EngineServer(SlotEngine(model, n_slots=2, chunk_steps=8),
                      TranscribeOptions(temperature=0.0), max_queue=0) as srv:
        with pytest.raises(ServerBusy):
            srv.submit(audio)
        with _Http(srv) as conn:
            conn.request("POST", "/transcribe", body=_wav(audio))
            resp = conn.getresponse()
            assert resp.status == 503 and resp.getheader("Retry-After") == "1"
            conn.request("POST", "/transcribe", body=b"",
                         headers={"Content-Length": str(10 ** 12)})
            assert conn.getresponse().status == 413
            conn.close()


def test_translations_task_override(tmp_path):
    """Per-request task: submit(task='translate') gives a translate
    engine's result beside a transcribe request in the same engine, and
    /v1/audio/translations serves it (verbose_json says so)."""
    path = str(tmp_path / "ggml-micro-ml.bin")
    write_synthetic_ggml(path, micro_config(n_vocab=51865), seed=17)
    ml = load_model(path, device="cpu", use_native=False)
    assert ml.vocab.is_multilingual
    audio = _heard(synthetic_audio(SR * 4, seed=21))  # micro: 1.28 s windows
    topts = TranscribeOptions(temperature=0.0, condition_on_previous_text=True)
    ref_tr = SlotEngine(ml, n_slots=2, chunk_steps=8).transcribe_streams([audio], topts)[0]
    ref_xl = SlotEngine(ml, n_slots=2, chunk_steps=8).transcribe_streams(
        [audio], dataclasses.replace(topts, task="translate"))[0]
    with EngineServer(SlotEngine(ml, n_slots=2, chunk_steps=8), topts) as srv:
        with pytest.raises(ValueError, match="unknown task"):
            srv.submit(audio, task="summarize")
        fut_xl, fut_tr = srv.submit(audio, task="translate"), srv.submit(audio)
        assert _tokens(fut_xl.result(timeout=WAIT)) == _tokens(ref_xl)
        assert _tokens(fut_tr.result(timeout=WAIT)) == _tokens(ref_tr)
        boundary = "XtRaNsLaTeX"
        with _Http(srv) as conn:
            conn.request("POST", "/v1/audio/translations", body=_multipart(
                boundary, {"file": ("a.wav", _wav(audio)),
                           "response_format": (None, b"verbose_json")}),
                headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
            resp = conn.getresponse()
            assert resp.status == 200
            v = json.loads(resp.read())
            assert v["task"] == "translate" and v["text"] == ref_xl["text"]
            conn.close()


def test_multi_engine_server_dp(model):
    """Two engine replicas (CPU engines here; one card each under cli serve
    --dp) behind one MultiEngineServer: a single engine's results, the
    burst spread over both, health and stats pooled, and the HTTP front end
    over it."""
    audios = [_heard(synthetic_audio(SR * (1 + i), seed=i)) for i in range(4)]
    topts = TranscribeOptions(temperature=0.0)
    ref = SlotEngine(model, n_slots=2, chunk_steps=8).transcribe_streams(audios, topts)
    members = [EngineServer(SlotEngine(model, n_slots=2, chunk_steps=8), topts)
               for _ in range(2)]
    with MultiEngineServer(members) as srv:
        got = [f.result(timeout=WAIT) for f in [srv.submit(a) for a in audios]]
        health, stats = srv.health(), srv.stats_dict()
        with _Http(srv) as conn:
            conn.request("GET", "/healthz")
            assert json.loads(conn.getresponse().read())["replicas_ok"] == 2
            conn.request("POST", "/transcribe", body=_wav(audios[0]))
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["text"] == ref[0]["text"]
            conn.request("GET", "/metrics")
            body = conn.getresponse().read().decode()
            assert "# TYPE whisper_replicas gauge" in body and "whisper_requests 5" in body
            conn.close()
    for r, g in zip(ref, got):
        assert (g["text"], _tokens(g)) == (r["text"], _tokens(r))
    reqs = [m.engine.stats["requests"] for m in members]
    assert sum(reqs) == 5 and all(r >= 1 for r in reqs)
    assert health["ok"] is True and health["replicas_ok"] == 2
    assert stats["requests"] == 4 and stats["replicas"] == 2
    assert stats["latency"]["n"] == 4 and len(stats["engines"]) == 2
    with pytest.raises(ValueError):
        MultiEngineServer([])


def test_engine_server_cancel(model):
    """cancel(): an admitted long stream stops at its next window boundary
    (CancelledError, slot freed), a queued request is dropped before it
    starts, and cancelling a finished future returns False."""
    long_audio, short_audio = synthetic_audio(SR * 60, seed=11), synthetic_audio(SR * 2, seed=3)
    topts = TranscribeOptions(temperature=0.0)
    ref_short = SlotEngine(model, n_slots=1, chunk_steps=8).transcribe_streams(
        [short_audio], topts)[0]
    with EngineServer(SlotEngine(model, n_slots=1, chunk_steps=8), topts) as srv:
        first_seg = threading.Event()
        fut_long = srv.submit(long_audio, on_segment=lambda seg: first_seg.set())
        fut_q = srv.submit(short_audio)  # queued behind the only slot
        assert first_seg.wait(timeout=WAIT)
        assert srv.cancel(fut_q) is True and srv.cancel(fut_long) is True
        for fut in (fut_q, fut_long):
            with pytest.raises(CancelledError):
                fut.result(timeout=WAIT)
        got = srv.submit(short_audio).result(timeout=WAIT)
        assert _tokens(got) == _tokens(ref_short)
        done = srv.submit(short_audio)
        done.result(timeout=WAIT)
        assert srv.cancel(done) is False
    assert srv.inflight == 0


def test_engine_server_request_deadline(model):
    """Deadlines: an expired queued request resolves TimeoutError without
    decoding; a long stream expires at a scheduling boundary and frees its
    slot; HTTP maps expiry to 504 through ?timeout= and a bad value to 400."""
    short, long_audio = synthetic_audio(SR * 2, seed=3), synthetic_audio(SR * 300, seed=11)
    with EngineServer(SlotEngine(model, n_slots=1, chunk_steps=8),
                      TranscribeOptions(temperature=0.0)) as srv:
        with pytest.raises(TimeoutError):
            srv.submit(short, timeout_s=1e-6).result(timeout=WAIT)
        with pytest.raises(TimeoutError):
            srv.submit(long_audio, timeout_s=0.5).result(timeout=WAIT)
        assert srv.submit(short).result(timeout=WAIT)["duration"] == pytest.approx(2.0, abs=0.01)
        with _Http(srv) as conn:
            conn.request("POST", "/transcribe?timeout=0.000001", body=_wav(short))
            resp = conn.getresponse()
            assert resp.status == 504 and "deadline" in json.loads(resp.read())["error"]
            conn.request("POST", "/transcribe?timeout=notanumber", body=_wav(short))
            assert conn.getresponse().status == 400
            conn.close()


def test_engine_server_queued_deadline_not_starved(model):
    """A queued request's deadline resolves while a long stream holds the
    only slot (the worker sweeps waiting requests every round); the OpenAI
    endpoint honours ?timeout= with 504."""
    long_audio, short = synthetic_audio(SR * 300, seed=11), synthetic_audio(SR * 2, seed=3)
    engine = SlotEngine(model, n_slots=1, chunk_steps=8)
    with EngineServer(engine, TranscribeOptions(temperature=0.0)) as srv:
        first_seg = threading.Event()
        fut_long = srv.submit(long_audio, on_segment=lambda seg: first_seg.set())
        assert first_seg.wait(timeout=WAIT)  # admitted: it holds the slot
        fut_q = srv.submit(short, timeout_s=0.2)
        with pytest.raises(TimeoutError):
            fut_q.result(timeout=WAIT)
        # the long stream (300 s of 1.28 s windows) was still decoding
        assert not fut_long.done()
        srv.cancel(fut_long)
        boundary = "XtImEoUtX"
        with _Http(srv) as conn:
            conn.request("POST", "/v1/audio/transcriptions?timeout=0.000001",
                         body=_multipart(boundary, {"file": ("a.wav", _wav(short))}),
                         headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
            resp = conn.getresponse()
            assert resp.status == 504 and "deadline" in json.loads(resp.read())["error"]
            conn.close()
        with pytest.raises(CancelledError):
            fut_long.result(timeout=WAIT)


def test_engine_server_stop_nodrain_fast(model):
    """stop(drain=False) returns without finishing in-flight long streams
    (no later window is admitted) and cancels their futures and the queued
    ones: the worker ends after the round it is in."""
    long_audio = synthetic_audio(SR * 300, seed=11)
    engine = SlotEngine(model, n_slots=1, chunk_steps=8)
    srv = EngineServer(engine, TranscribeOptions(temperature=0.0)).start()
    first_seg = threading.Event()
    fut_long = srv.submit(long_audio, on_segment=lambda seg: first_seg.set())
    fut_queued = srv.submit(long_audio)
    assert first_seg.wait(timeout=WAIT)
    srv.stop(drain=False)
    assert srv._thread is None
    assert engine.stats["windows"] < 200  # 300 s of 1.28 s windows: most never ran
    for fut in (fut_long, fut_queued):
        with pytest.raises(CancelledError):
            fut.result(timeout=5)
