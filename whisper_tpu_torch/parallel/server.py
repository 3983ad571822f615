"""Serving daemon: a live request queue over the continuous-batching engine.

Port of ``whisper_tpu/parallel/server.py``. ``EngineServer`` drives a
``SlotEngine`` (or ``BeamSlotEngine``) from a thread-safe queue on ONE
dedicated worker thread, the only thread that touches THIS engine's CUDA
state (slot pools and scheduler bookkeeping are single-owner by design;
HTTP handler threads never launch anything). CUDA's current device is per
thread, so the worker enters the engine's device before it launches
anything. Under ``MultiEngineServer`` each replica has its own worker
thread over its own card (``cli serve --dp N``: ``cuda:0`` .. ``cuda:N-1``).
Requests admit into slots as they free up, long audio runs the whisper_full
sliding-window loop per stream (the same ``_advance_stream`` bookkeeping as
``transcribe_streams``), and each request resolves a
``concurrent.futures.Future``, so N HTTP handler threads block cheaply while
the card stays busy across requests.

``make_http_server`` is the dependency-free stdlib front end:

    POST /transcribe  (body: WAV bytes)          -> {text, segments, language, ...}
    POST /transcribe?stream=1                    -> NDJSON: one line per segment
                                                    as it finalizes, then a
                                                    summary line
    POST /v1/audio/transcriptions (multipart)    -> OpenAI-audio-API-compatible
                                                    (file, language, prompt,
                                                    response_format: json|text|
                                                    verbose_json|srt|vtt)
    POST /v1/audio/translations (multipart)      -> same surface, decoded with
                                                    the translate task token
                                                    (X -> English)
    GET  /healthz                                -> {ok}
    GET  /stats                                  -> engine phase stats + queue depth
    GET  /metrics                                -> the same numbers, Prometheus text

``cli serve`` wires this up. The front end is host code only: the
standard library, ``io.wav`` and ``utils.writers``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future
from typing import Optional

import numpy as np
import torch


class ServerBusy(RuntimeError):
    """Raised by ``submit`` when the request queue is at ``max_queue``
    (HTTP front end maps it to 503)."""


def _latency_percentiles(lats: list) -> dict:
    """p50/p95/p99 total (submit -> result) and mean/max queue wait
    (submit -> first slot) over [(wait, total), ...] samples. Callers pass
    a SNAPSHOT (``list(deque)`` holds the GIL through the copy) — iterating
    a live deque races the worker's appends."""
    if not lats:
        return {"n": 0}
    total = sorted(t for _, t in lats)
    waits = [w for w, _ in lats]

    def pct(p):
        return total[min(len(total) - 1, int(p * len(total)))]

    return {
        "n": len(lats),
        "total_p50_s": round(pct(0.50), 4),
        "total_p95_s": round(pct(0.95), 4),
        "total_p99_s": round(pct(0.99), 4),
        "queue_wait_mean_s": round(sum(waits) / len(waits), 4),
        "queue_wait_max_s": round(max(waits), 4),
    }


class EngineServer:
    """Queue-fed long-form transcription over an engine's slot pool.

    The worker runs the engine's own long-form scheduler
    (``SlotEngine._schedule_streams``, as ``transcribe_streams`` does) with a
    live queue as the stream source: admit (bucketed encode/prefill) ->
    dispatch one decode chunk (async) -> harvest the previous round's
    snapshot -> resolve finished streams. When idle it blocks on the queue.
    """

    def __init__(self, engine, options=None, poll_s: float = 0.05,
                 max_queue: Optional[int] = None,
                 request_timeout_s: Optional[float] = None):
        from ..pipeline.transcribe import TranscribeOptions

        self.engine = engine
        self.topts = options or TranscribeOptions()
        self.request_timeout_s = request_timeout_s
        engine._check_stream_options(self.topts)
        # rule masks / temperature ladder are (re)built by the worker at
        # start() — NOT here — so an engine.warmup() run between
        # construction and start() (with its own options) cannot leave
        # stale suppress masks behind
        self._queue: queue.Queue = queue.Queue()
        self._poll_s = poll_s
        self._max_queue = max_queue
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._cancelled: set = set()  # futures marked by cancel()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        self._idx = 0
        # last-1000 per-request latencies (seconds): (queue wait to first
        # slot, total submit->resolve). Percentiles via latency_stats().
        self._latencies: deque = deque(maxlen=1000)

    # -- client surface (any thread) --

    def submit(self, audio: np.ndarray, on_segment=None,
               language: Optional[str] = None,
               initial_prompt: Optional[str] = None,
               task: Optional[str] = None,
               timeout_s: Optional[float] = None) -> Future:
        """Enqueue one request; the Future resolves to the transcribe-style
        result dict ({text, segments, language, duration}).

        ``on_segment`` (called on the worker thread with each segment dict
        as its window finalizes) backs the streaming HTTP response — keep it
        cheap (push to a queue). ``language``/``initial_prompt``/``task``
        override the server options per request; they only feed the stream's
        own options (``_init_stream`` stores them on the stream dict, and
        ``_window_options`` reads them back for every window + fallback
        decode), so mixing them across live slots is safe.

        ``timeout_s`` (default: the server's ``request_timeout_s``) is a
        server-side deadline: past it the request resolves with
        TimeoutError — before starting if still queued, else at the
        stream's next window boundary (same granularity as cancel())."""
        if task is not None and task not in ("transcribe", "translate"):
            raise ValueError(f"unknown task {task!r}")
        if self._thread is None or not self._thread.is_alive():
            raise RuntimeError(
                "EngineServer is not running; call start()"
                + (f" (worker died: {self._fatal!r})" if self._fatal else ""))
        fut: Future = Future()
        # Track IN-FLIGHT requests (queued + admitted), not raw queue depth
        # — the worker drains the queue into its pending list immediately.
        # Always counted: backpressure uses it when max_queue is set, and
        # MultiEngineServer routes new requests by it.
        with self._inflight_lock:
            if (self._max_queue is not None
                    and self._inflight >= self._max_queue):
                raise ServerBusy(
                    f"{self._inflight} requests in flight "
                    f"(max_queue={self._max_queue})")
            self._inflight += 1

        def _dec(_f):
            with self._inflight_lock:
                self._inflight -= 1
                self._cancelled.discard(_f)

        fut.add_done_callback(_dec)
        fut._engine_server = self  # cancel() routing under MultiEngineServer
        if timeout_s is None:
            timeout_s = self.request_timeout_s
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        self._queue.put((audio, fut, on_segment, language, initial_prompt,
                         task, deadline, time.monotonic()))
        # The entry liveness check races a concurrent stop(): if the worker
        # died between it and the put, stop()'s final drain may already have
        # run and nothing would ever consume this item — drain-and-cancel
        # ourselves (idempotent with stop()'s own drain).
        if self._thread is None or not self._thread.is_alive():
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not item[1].done():
                    item[1].cancel()
        return fut

    def cancel(self, fut: Future) -> bool:
        """Stop work on an in-flight submit (e.g. the HTTP client
        disconnected). Queued requests are dropped before they start;
        admitted streams are dropped at their next WINDOW boundary — the
        engine decodes in fixed chunks, so mid-window rows finish their
        current window and then free for reuse. The future resolves with
        CancelledError. Returns False when the result already landed."""
        with self._inflight_lock:
            if fut.done():
                return False
            self._cancelled.add(fut)
        return True

    def _pop_cancelled(self, fut: Future, deadline=None) -> bool:
        """Worker-side check: consume a cancel() mark or an expired
        deadline and resolve the future. True -> drop the stream/request."""
        with self._inflight_lock:
            marked = fut in self._cancelled
            self._cancelled.discard(fut)
        if marked:
            if not fut.done():
                fut.set_exception(CancelledError())
            return True
        if deadline is not None and time.monotonic() > deadline:
            if not fut.done():
                fut.set_exception(TimeoutError(
                    "request exceeded its server-side deadline"))
            return True
        return False

    @property
    def inflight(self) -> int:
        """Requests submitted but not yet resolved (queued + admitted)."""
        with self._inflight_lock:
            return self._inflight

    def health(self) -> dict:
        """{"ok": worker alive, "error": repr} — the HTTP /healthz body."""
        alive = self._thread is not None and self._thread.is_alive()
        payload = {"ok": alive}
        if self._fatal is not None:
            payload["error"] = repr(self._fatal)
        return payload

    def stats_dict(self) -> dict:
        """Engine phase stats + queue depth + latency percentiles — the
        HTTP /stats body."""
        stats = dict(getattr(self.engine, "stats", {}) or {})
        stats["queue_depth"] = self.queue_depth
        stats["latency"] = self.latency_stats()
        return stats

    def latency_stats(self) -> dict:
        """Request latency over the last <=1000 resolved requests
        (percentiles via ``_latency_percentiles``)."""
        return _latency_percentiles(list(self._latencies))

    def transcribe(self, audio: np.ndarray, timeout: Optional[float] = None):
        return self.submit(audio).result(timeout)

    def start(self) -> "EngineServer":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="engine-server",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the worker. ``drain=True`` finishes queued/in-flight requests
        first; otherwise pending futures are cancelled."""
        self._drain = drain
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # items that raced past the worker's exit (or arrived after a fatal
        # worker death) must not leave their futures hanging
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if not item[1].done():
                item[1].cancel()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    # -- the worker loop (owns every CUDA call of its engine) --

    def _run(self) -> None:
        self._drain = True
        self._fatal = None
        eng, topts = self.engine, self.topts
        pending: list = []       # initialized streams between windows
        raw: list = []           # not-yet-initialized requests (host-only)
        slot_stream = [None] * eng.n_slots
        try:
            # inference mode and the current CUDA device are per thread
            with torch.inference_mode(), (torch.cuda.device(eng.device)
                                          if eng.device.type == "cuda"
                                          else contextlib.nullcontext()):
                temps = eng._prepare_streams(topts)
                eng.stats = {"admit_s": 0.0, "chunk_s": 0.0, "pull_s": 0.0,
                             "fallback_s": 0.0, "ingest_s": 0.0, "init_s": 0.0,
                             "harvest_s": 0.0, "rounds": 0, "windows": 0,
                             "fallbacks": 0, "requests": 0, "decode_steps": 0,
                             "encode_windows": 0, "encode_rows": 0, "encode_buckets": 0}
                # transcribe_streams' scheduler, fed by the live queue
                eng._schedule_streams(
                    topts, slot_stream,
                    keep_going=lambda busy: self._ingest(busy, pending, raw),
                    next_stream=lambda: self._next_stream(pending, raw),
                    finish=lambda s, st, pulled: self._finish(s, st, pulled, pending,
                                                              temps))
        except Exception as e:  # noqa: BLE001 — the engine died; fail fast
            self._fatal = e
        finally:
            # Resolve EVERYTHING still outstanding so no client ever hangs
            # on a dead worker: in-flight streams, raw requests, and any
            # queue items that raced past the final empty check (submit()'s
            # put can land after the worker decided to exit).
            # a non-drain stop abandons in-flight work by contract — those
            # futures CANCEL; a fatal error or drain-stop races get the error
            err = self._fatal or (
                RuntimeError("EngineServer stopped") if self._drain
                else CancelledError())
            for st in pending + [s for s in slot_stream if s is not None]:
                if not st["future"].done():
                    st["future"].set_exception(err)
            for item in raw:
                if not item[1].done():
                    item[1].set_exception(err)
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not item[1].done():
                    item[1].cancel()

    def _ingest(self, busy: bool, pending: list, raw: list) -> bool:
        """The scheduler's round start: False to stop the worker; else move
        queued requests into ``raw`` (host memory only: device staging waits
        for a free slot, so queued bursts cannot exhaust device memory),
        blocking up to ``poll_s`` only when idle, and drop the cancelled or
        expired requests that wait. A stage (``server.ingest``, ``ingest_s``),
        its wait included."""
        with self.engine.spans.stage("server.ingest", "ingest_s"):
            busy = busy or bool(raw or pending)
            # drain=False means FAST shutdown: exit even while streams are
            # mid-flight (between-window continuations must not be re-admitted
            # for hours) — _run's finally cancels their futures
            if self._stop.is_set() and (not self._drain or (not busy and self._queue.empty())):
                return False
            try:
                while True:
                    item = self._queue.get(block=not busy, timeout=self._poll_s)
                    if self._stop.is_set() and not self._drain:
                        item[1].cancel()
                        continue
                    raw.append(item)
                    busy = True
            except queue.Empty:
                pass
            # sweep cancelled/expired WAITING requests every round — not only at
            # slot-admission pop — so a queued request's cancel() or deadline
            # resolves promptly even while long streams hold every slot for
            # minutes (and stops counting toward the max_queue backpressure)
            raw[:] = [it for it in raw if not self._pop_cancelled(it[1], it[6])]
            pending[:] = [st for st in pending
                          if not self._pop_cancelled(st["future"], st.get("deadline"))]
            return True

    def _next_stream(self, pending: list, raw: list) -> Optional[dict]:
        """The next stream for a free slot: window continuations first, then
        new requests (initialized here, at admission: mel upload, language
        detect, prompt tokenization); None when there is none."""
        while pending or raw:
            if pending:
                st = pending.pop(0)
                if self._pop_cancelled(st["future"], st.get("deadline")):
                    continue
            else:
                item = raw.pop(0)
                if self._pop_cancelled(item[1], item[6]):
                    continue
                st = self._start_request(item)
                if st is None:  # bad request / too short: resolved
                    continue
            st.setdefault("t_first_slot", time.monotonic())
            return st
        return None

    def _finish(self, s: int, st: dict, pulled, pending: list, temps) -> None:
        """A stream's window finished in slot ``s`` (already freed): advance
        it, stream its new segments, then resolve its future or queue its
        next window."""
        if self._pop_cancelled(st["future"], st.get("deadline")):
            return
        try:
            done = self.engine._advance_stream(s, st, pulled, self.topts, temps)
        except Exception as e:  # noqa: BLE001
            self._record_latency(st)
            self._resolve(st, e)
            return
        if st.get("on_segment") is not None:
            for seg in st["segments"][st["emitted"]:]:
                try:
                    st["on_segment"](dataclasses.asdict(seg))
                except Exception:  # noqa: BLE001 — client's problem
                    pass
            st["emitted"] = len(st["segments"])
        if done:
            self._record_latency(st)
            self._resolve(st)
        else:
            pending.append(st)

    def _resolve(self, st: dict, error: Optional[BaseException] = None) -> None:
        """Resolve a stream's future with its output, or ``error``, in a
        stage (``server.resolve``): the future's done callbacks run in it."""
        with self.engine.spans.stage("server.resolve", None, ids=(st["idx"],)):
            if error is not None:
                st["future"].set_exception(error)
            else:
                st["future"].set_result(self.engine._stream_output(st))

    def _start_request(self, item) -> Optional[dict]:
        """Initialize one raw request (device mel staging, language detect,
        prompt tokenization) in a stage (``server.start_request``,
        ``init_s``). Returns the stream dict, or None when the request
        resolved immediately (bad input / shorter than one hop)."""
        audio, fut, on_seg, lang, prompt, task, deadline, t_sub = item
        if not fut.set_running_or_notify_cancel():
            return None
        eng, topts = self.engine, self.topts
        st_topts = topts
        if lang is not None or prompt is not None or task is not None:
            st_topts = dataclasses.replace(
                topts,
                language=lang if lang is not None else topts.language,
                task=task if task is not None else topts.task,
                initial_prompt=(prompt if prompt is not None
                                else topts.initial_prompt))
        try:
            with eng.spans.stage("server.start_request", "init_s", ids=(self._idx,)):
                st = eng._init_stream(self._idx, audio, st_topts)
        except Exception as e:  # noqa: BLE001 — bad request only
            fut.set_exception(e)
            return None
        self._idx += 1
        st["future"] = fut
        st["on_segment"] = on_seg
        st["emitted"] = 0
        st["t_sub"] = t_sub
        st["deadline"] = deadline
        eng.stats["requests"] += 1
        if st["done"]:  # shorter than one hop: no windows
            dt = time.monotonic() - t_sub
            self._latencies.append((dt, dt))  # never slotted: all queue wait
            fut.set_result(eng._stream_output(st))
            return None
        return st

    def _record_latency(self, st: dict) -> None:
        now = time.monotonic()
        self._latencies.append(
            (st.get("t_first_slot", now) - st["t_sub"], now - st["t_sub"]))


class MultiEngineServer:
    """Data-parallel serving: one ``EngineServer`` per engine replica, each
    replica owning its own card.

    Request-level data parallelism runs INDEPENDENT engine replicas and
    routes each request to the least-loaded one (throughput): no collectives
    cross replicas, inside one daemon with one queue discipline. ``cli serve
    --dp N`` builds it over ``cuda:0`` .. ``cuda:N-1``; the HTTP front end
    is unchanged (it only needs submit/health/stats_dict).
    """

    def __init__(self, servers):
        if not servers:
            raise ValueError("MultiEngineServer needs at least one member")
        self.servers = list(servers)
        self.topts = self.servers[0].topts

    # -- lifecycle --

    def start(self) -> "MultiEngineServer":
        for s in self.servers:
            s.start()
        return self

    def stop(self, drain: bool = True) -> None:
        for s in self.servers:
            s.stop(drain=drain)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client surface --

    def submit(self, audio, **kwargs) -> Future:
        """Route to the member with the fewest in-flight requests (ties ->
        lowest index). Dead members are skipped so one crashed replica
        degrades capacity instead of failing the daemon; if ALL are dead,
        delegate to member 0 for its usual not-running error."""
        live = [s for s in self.servers
                if s._thread is not None and s._thread.is_alive()]
        target = min(live, key=lambda s: s.inflight) if live \
            else self.servers[0]
        return target.submit(audio, **kwargs)

    def transcribe(self, audio, timeout=None):
        return self.submit(audio).result(timeout)

    def cancel(self, fut) -> bool:
        """Route cancel() to the replica that owns the future."""
        owner = getattr(fut, "_engine_server", None)
        return owner.cancel(fut) if owner is not None else False

    @property
    def queue_depth(self) -> int:
        return sum(s.queue_depth for s in self.servers)

    @property
    def inflight(self) -> int:
        return sum(s.inflight for s in self.servers)

    def health(self) -> dict:
        """ok while ANY replica is serving; per-replica detail included."""
        members = [s.health() for s in self.servers]
        return {"ok": any(m["ok"] for m in members),
                "replicas": len(members),
                "replicas_ok": sum(m["ok"] for m in members),
                "members": members}

    def latency_stats(self) -> dict:
        """Percentiles over the members' pooled recent-request samples
        (each member's deque snapshotted before pooling — see
        ``_latency_percentiles``)."""
        return _latency_percentiles(
            [lat for s in self.servers for lat in list(s._latencies)])

    def stats_dict(self) -> dict:
        """Counters summed across replicas (+ per-replica breakdown)."""
        per = [s.stats_dict() for s in self.servers]
        agg: dict = {}
        for p in per:
            for k, v in p.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
        agg["replicas"] = len(per)
        agg["latency"] = self.latency_stats()
        agg["engines"] = per
        return agg


def parse_multipart(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser (stdlib-only; ``cgi`` is gone in
    3.13): {field name -> bytes}. Enough for the OpenAI audio API surface
    (a ``file`` part + short text fields)."""
    import re

    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("multipart body without a boundary parameter")
    boundary = b"--" + m.group(1).encode()
    fields = {}
    for part in body.split(boundary)[1:]:
        if part[:2] in (b"--", b""):  # closing delimiter / preamble
            continue
        part = part.lstrip(b"\r\n")
        head, _, value = part.partition(b"\r\n\r\n")
        # strip exactly ONE trailing CRLF (the part delimiter) — binary
        # payloads legitimately end in 0x0d/0x0a bytes (e.g. int16 PCM),
        # so rstrip would corrupt roughly 1-in-128 WAV uploads.
        if value.endswith(b"\r\n"):
            value = value[:-2]
        # must not match the 'name="' inside 'filename="..."' — RFC 7578
        # does not mandate parameter order, so filename may come first
        dm = re.search(rb'(?:^|[;\s])name="([^"]+)"', head)
        if dm:
            fields[dm.group(1).decode()] = value
    return fields


def openai_response(result: dict, response_format: str,
                    task: str = "transcribe"):
    """(payload, content_type) in the OpenAI audio-API shape for
    ``response_format`` json|text|verbose_json|srt|vtt. Our segments carry
    t0/t1 (whisper.cpp naming); verbose_json maps them to start/end."""
    import io as _io

    from ..utils.writers import write_srt, write_vtt

    if response_format == "json":
        return json.dumps({"text": result["text"]},
                          ensure_ascii=False), "application/json"
    if response_format == "verbose_json":
        segs = [{
            "id": s["id"], "seek": s["seek"], "start": s["t0"],
            "end": s["t1"], "text": s["text"], "tokens": s["tokens"],
            "temperature": s["temperature"],
            "avg_logprob": s["avg_logprob"],
            "compression_ratio": s["compression_ratio"],
            "no_speech_prob": s["no_speech_prob"],
            **({"words": s["words"]} if s.get("words") else {}),
        } for s in result["segments"]]
        return json.dumps({
            "task": task, "language": result["language"],
            "duration": result["duration"], "text": result["text"],
            "segments": segs,
        }, ensure_ascii=False), "application/json"
    if response_format == "text":
        return result["text"] + "\n", "text/plain; charset=utf-8"
    if response_format in ("srt", "vtt"):
        buf = _io.StringIO()
        (write_srt if response_format == "srt" else write_vtt)(result, buf)
        return buf.getvalue(), "text/plain; charset=utf-8"
    raise ValueError(f"unknown response_format {response_format!r}")


def make_http_server(server: EngineServer, host: str = "127.0.0.1",
                     port: int = 8080,
                     max_body_bytes: int = 256 * 1024 * 1024):
    """A ``ThreadingHTTPServer`` bound to ``host:port`` serving the
    EngineServer. Handler threads only parse WAVs and block on futures; all
    device work stays on the engine worker thread. Bodies past
    ``max_body_bytes`` (default 256 MB ≈ 2.3 h of 16 kHz int16 WAV) get 413
    before anything is read into memory."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..io.wav import load_wav_bytes

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload, ctype="application/json") -> None:
            if isinstance(payload, dict):
                payload = json.dumps(payload, ensure_ascii=False)
            body = payload.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # stdlib default spams stderr
            pass

        def do_GET(self):
            if self.path == "/healthz":
                payload = server.health()
                self._reply(200 if payload["ok"] else 503, payload)
            elif self.path == "/stats":
                self._reply(200, server.stats_dict())
            elif self.path == "/metrics":
                # Prometheus text exposition of the same numbers.
                stats = server.stats_dict()
                lat = stats.pop("latency", None) or {}
                stats.pop("engines", None)
                lines = []
                for k, v in stats.items():
                    if isinstance(v, (int, float)):
                        kind = ("gauge" if k in ("queue_depth", "replicas")
                                else "counter")
                        lines.append(f"# TYPE whisper_{k} {kind}")
                        lines.append(f"whisper_{k} {v}")
                if lat.get("n"):
                    lines.append("# TYPE whisper_request_latency_seconds "
                                 "summary")
                    for q, key in (("0.5", "total_p50_s"),
                                   ("0.95", "total_p95_s"),
                                   ("0.99", "total_p99_s")):
                        lines.append("whisper_request_latency_seconds"
                                     f'{{quantile="{q}"}} {lat[key]}')
                    lines.append("whisper_request_latency_seconds_count "
                                 f"{lat['n']}")
                self._reply(200, "\n".join(lines) + "\n",
                            "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(404, {"error": "not found"})

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                self._reply(400, {"error": "empty body"})
                return None
            if n > max_body_bytes:
                self._reply(413, {"error": f"body {n} bytes > limit "
                                           f"{max_body_bytes}"})
                return None
            return self.rfile.read(n)

        def _submit(self, audio, on_segment=None, language=None,
                    prompt=None, task=None, timeout_s=None):
            """submit() with ServerBusy/dead-worker -> 503; returns the
            Future or None (response already sent)."""
            try:
                return server.submit(audio, on_segment=on_segment,
                                     language=language,
                                     initial_prompt=prompt, task=task,
                                     timeout_s=timeout_s)
            except (ServerBusy, RuntimeError) as e:
                # ServerBusy: queue full. RuntimeError: the engine worker
                # died (submit()'s not-running error) — either way the
                # client gets a retryable 503 instead of a dropped socket.
                self.send_response(503)
                self.send_header("Retry-After", "1")
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            route = url.path.rstrip("/")
            q = parse_qs(url.query)
            try:
                timeout_s = float(q["timeout"][0]) if "timeout" in q \
                    else None
            except ValueError:
                self._reply(400, {"error": "bad timeout parameter"})
                return
            if route in ("/transcribe", "/v1/transcribe"):
                data = self._read_body()
                if data is None:
                    return
                try:
                    audio = load_wav_bytes(data)
                except Exception as e:  # noqa: BLE001
                    self._reply(400, {"error": str(e)})
                    return
                stream = (q.get("stream", ["0"])[0] not in ("0", "")
                          or "ndjson" in (self.headers.get("Accept") or ""))
                if stream:
                    self._stream_response(audio, timeout_s=timeout_s)
                    return
                fut = self._submit(audio, timeout_s=timeout_s)
                if fut is None:
                    return
                try:
                    self._reply(200, fut.result())
                except TimeoutError as e:
                    self._reply(504, {"error": str(e)})
                except CancelledError:
                    # BaseException, NOT Exception — without this clause a
                    # stop(drain=False) mid-request kills the handler thread
                    # and the client sees a connection reset, not a response
                    self._reply(503, {"error": "request cancelled"})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error": str(e)})
                return
            if route == "/v1/audio/transcriptions":
                self._openai_transcription(timeout_s=timeout_s)
                return
            if route == "/v1/audio/translations":
                # OpenAI translations endpoint: same multipart surface,
                # decode with the translate task token (X -> English)
                self._openai_transcription(task="translate",
                                           timeout_s=timeout_s)
                return
            self._reply(404, {"error": "not found"})

        def _stream_response(self, audio, timeout_s=None) -> None:
            """NDJSON: one line per segment as its window finalizes, then a
            summary line. Close-delimited (no Content-Length)."""
            done_q: queue.Queue = queue.Queue()
            fut = self._submit(
                audio, on_segment=lambda seg: done_q.put(("segment", seg)),
                timeout_s=timeout_s)
            if fut is None:
                return
            fut.add_done_callback(lambda f: done_q.put(("done", f)))
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")
            self.end_headers()
            while True:
                kind, item = done_q.get()
                if kind == "segment":
                    line = {"segment": item}
                else:
                    try:
                        r = item.result()
                        line = {"done": True, "text": r["text"],
                                "language": r["language"],
                                "duration": r["duration"]}
                    except CancelledError:  # BaseException — see do_POST
                        line = {"done": True, "error": "request cancelled"}
                    except Exception as e:  # noqa: BLE001
                        line = {"done": True, "error": str(e)}
                try:
                    self.wfile.write(
                        (json.dumps(line, ensure_ascii=False) + "\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # client went away (FIN -> EPIPE or RST -> ECONNRESET):
                    # stop decoding its stream — the slot frees at the next
                    # window boundary
                    server.cancel(fut)
                    return
                if kind == "done":
                    return

        def _openai_transcription(self, task=None, timeout_s=None) -> None:
            """OpenAI audio API: multipart/form-data with file, and optional
            language / prompt / response_format (json default). ``task``
            pins the decode task ("translate" for /v1/audio/translations)."""
            ctype = self.headers.get("Content-Type", "")
            data = self._read_body()
            if data is None:
                return
            if not ctype.startswith("multipart/form-data"):
                self._reply(400, {"error": "expected multipart/form-data"})
                return
            try:
                fields = parse_multipart(data, ctype)
            except Exception as e:  # noqa: BLE001
                self._reply(400, {"error": f"bad multipart body: {e}"})
                return
            if "file" not in fields:
                self._reply(400, {"error": "missing 'file' field"})
                return
            try:
                audio = load_wav_bytes(fields["file"])
            except Exception as e:  # noqa: BLE001
                self._reply(400, {"error": str(e)})
                return
            fmt = fields.get("response_format", b"json").decode() or "json"
            language = fields.get("language")
            prompt = fields.get("prompt")
            fut = self._submit(
                audio,
                language=language.decode() if language else None,
                prompt=prompt.decode() if prompt else None,
                task=task, timeout_s=timeout_s)
            if fut is None:
                return
            try:
                result = fut.result()
                payload, out_ctype = openai_response(
                    result, fmt, task=task or server.topts.task)
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
                return
            except CancelledError:  # BaseException — see do_POST
                self._reply(503, {"error": "request cancelled"})
                return
            except ValueError as e:
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, payload, out_ctype)

    return ThreadingHTTPServer((host, port), Handler)
