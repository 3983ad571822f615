"""Command-line interface of the port.

Port of ``whisper_tpu/cli.py`` with the same subcommands and flags:

    python -m whisper_tpu_torch.cli transcribe MODEL.bin AUDIO.wav [options]
    python -m whisper_tpu_torch.cli info MODEL.bin
    python -m whisper_tpu_torch.cli bench [MODEL.bin] [--seconds N]

Every subcommand that computes takes ``--device`` (default ``cuda``: the
card; ``cpu`` runs the kernels' plain versions), in place of the JAX
package's platform handling. ``export``, ``transcribe --draft``/``--tp``,
``batch --draft``/``--tp`` and ``serve --draft``/``--tp``/``--profiler-port``
stay in the parser and exit with an error naming the module they wait for. A ``WhisperError`` prints ``error: ...``
and exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .errors import WhisperError


def _device(args) -> str:
    """The subcommand's torch device; a CUDA device without a card raises."""
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise WhisperError(f"--device {args.device}: no CUDA card is available "
                           "(pass --device cpu to run on the CPU)")
    return args.device


def _dtype(name: str):
    import torch

    return torch.float32 if name == "float32" else torch.bfloat16


def _unported(what: str, module: str) -> WhisperError:
    return WhisperError(f"{what} needs {module}, which the PyTorch port does not have yet")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda, the card; cpu runs the kernels' "
                        "plain versions)")


def _add_transcribe_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", help="GGML checkpoint path")
    p.add_argument("audio", nargs="+", help="WAV file(s)")
    p.add_argument("--task", choices=["transcribe", "translate"], default="transcribe")
    p.add_argument("--language", default=None, help="force language (default: detect)")
    p.add_argument("--beam", type=int, default=None, help="beam size (default greedy)")
    p.add_argument("--best-of", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None,
                   help="single temperature (default: 0 with fallback ladder)")
    p.add_argument("--no-timestamps", action="store_true")
    p.add_argument("--token-timestamps", action="store_true",
                   help="compute per-token timestamps")
    p.add_argument("--word-timestamps", action="store_true",
                   help="word-level timestamps via cross-attention DTW")
    p.add_argument("--no-condition-on-previous-text", action="store_true")
    p.add_argument("--initial-prompt", default=None)
    p.add_argument("--mel-mode", choices=["openai", "reference"], default="openai")
    p.add_argument("--chunked", action="store_true",
                   help="chunk-parallel long-form mode (batched windows, "
                        "no prompt conditioning; fastest for long audio)")
    p.add_argument(
        "--audio-ctx", default=None,
        type=lambda s: "auto" if s == "auto" else int(s),
        help="encoder context override for short audio (speed); 'auto' "
             "derives it per window from the remaining content")
    p.add_argument("--offset-ms", type=int, default=0,
                   help="start transcription at this time "
                        "(whisper.cpp offset_ms; timestamps stay absolute)")
    p.add_argument("--duration-ms", type=int, default=None,
                   help="transcribe only this span past the offset "
                        "(whisper.cpp duration_ms)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--quantize-weights", action="store_true",
                   help="int8 decoder weights (serving mode; slight accuracy cost)")
    p.add_argument("--gelu", choices=["erf", "tanh"], default="erf")
    p.add_argument("--draft", default=None, metavar="DRAFT.bin",
                   help="draft GGML checkpoint for speculative greedy "
                        "decoding (not ported yet)")
    p.add_argument("--flash", action="store_true",
                   help="no effect: the port's encoder always runs its flash-attention kernel")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel over this many devices (not ported yet)")
    p.add_argument("--output-json", default=None, help="write result JSON here")
    p.add_argument("--output-format", "-f", default=None,
                   choices=["txt", "srt", "vtt", "tsv", "json", "all"],
                   help="write transcripts as <audio>.<ext> into "
                        "--output-dir (openai-whisper writer formats)")
    p.add_argument("--output-dir", "-o", default=".",
                   help="directory for --output-format files")
    p.add_argument("--highlight-words", action="store_true",
                   help="srt/vtt: one cue per word with the spoken word "
                        "underlined (needs --word-timestamps)")
    p.add_argument("--verbose", action="store_true")
    _add_device_arg(p)


def cmd_transcribe(args) -> int:
    if args.draft:
        raise _unported("--draft (speculative greedy decoding)",
                        "decoding/speculative.py and decoding/device_speculative.py")
    if args.tp and args.tp > 1:
        raise _unported("--tp (tensor parallelism)",
                        "parallel/mesh.py and parallel/sharding.py over a device mesh")
    from .model.load import load_model
    from .pipeline.transcribe import TranscribeOptions, transcribe

    model = load_model(args.model, device=_device(args), dtype=_dtype(args.dtype),
                       gelu_impl=args.gelu)
    if args.quantize_weights:
        from .model.quant import quantize_decoder_weights

        model = model.with_params(quantize_decoder_weights(model.params))
    opts = TranscribeOptions(
        task=args.task,
        language=args.language,
        beam_size=args.beam,
        best_of=args.best_of,
        without_timestamps=args.no_timestamps,
        token_timestamps=args.token_timestamps,
        word_timestamps=args.word_timestamps,
        condition_on_previous_text=not args.no_condition_on_previous_text,
        initial_prompt=args.initial_prompt,
        mel_mode=args.mel_mode,
        use_flash=args.flash,
        audio_ctx=args.audio_ctx,
        offset_ms=args.offset_ms,
        duration_ms=args.duration_ms,
        verbose=args.verbose,
    )
    if args.temperature is not None:
        opts.temperature = args.temperature

    if args.chunked:
        from .pipeline.chunked import transcribe_chunked as transcribe_fn
    else:
        transcribe_fn = transcribe

    all_results = {}
    for path in args.audio:
        t0 = time.perf_counter()
        result = transcribe_fn(model, path, opts)
        wall = time.perf_counter() - t0
        rtf = result["duration"] / wall if wall > 0 else float("inf")
        all_results[path] = result
        print(f"== {path} (lang={result['language']}, {result['duration']:.1f}s "
              f"audio in {wall:.1f}s, {rtf:.1f}x realtime)")
        for seg in result["segments"]:
            print(f"[{_fmt_ts(seg['t0'])} --> {_fmt_ts(seg['t1'])}] {seg['text']}")
        print(model.timers.report())
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(all_results, f, indent=2, ensure_ascii=False)
    if args.output_format:
        from .utils.writers import WRITERS, write_transcripts

        formats = (list(WRITERS) + ["json"] if args.output_format == "all"
                   else [args.output_format])
        for p in write_transcripts(all_results, args.output_dir, formats,
                                   highlight_words=args.highlight_words):
            print(f"wrote {p}")
    return 0


def _fmt_ts(t: float) -> str:
    from .utils.writers import _timestamp

    return _timestamp(t, always_include_hours=True, decimal_marker=".")


def cmd_info(args) -> int:
    from .io.ggml import load_ggml

    ckpt = load_ggml(args.model)
    c = ckpt.config
    print(f"model type     : {c.model_type}")
    print(f"multilingual   : {c.is_multilingual}")
    print(f"tensors        : {len(ckpt.tensors)}")
    print(f"filters        : {ckpt.filters.shape}")
    print(f"vocab (file)   : {len(ckpt.vocab.id_to_token)}")
    print(f"hbm estimate   : {c.hbm_bytes_estimate() / 2**20:.1f} MB")
    return 0


def cmd_convert(args) -> int:
    """Re-export a GGML checkpoint (f32 <-> f16), the whisper.cpp `quantize`
    tool's role for this format."""
    import dataclasses

    import numpy as np

    from .io.ggml import load_ggml, write_ggml

    ckpt = load_ggml(args.model)
    new_cfg = dataclasses.replace(ckpt.config, f16=1 if args.f16 else 0)
    tokens = [ckpt.vocab.id_to_token[i] for i in range(max(ckpt.vocab.id_to_token) + 1)]
    tensors = {k: np.asarray(v, dtype=np.float32) for k, v in ckpt.tensors.items()}
    write_ggml(args.out, new_cfg, ckpt.filters, tokens, tensors)
    print(f"wrote {args.out} (f16={new_cfg.f16})")
    return 0


def cmd_eval(args) -> int:
    """WER evaluation over a dataset directory.

    Layout: either LibriSpeech-style (*.trans.txt listing `utt_id text` with
    utt_id.flac/.wav next to it) or a flat dir of `name.wav` + `name.txt`.
    """
    from .model.load import load_model
    from .pipeline.transcribe import TranscribeOptions
    from .utils.wer import evaluate_dataset

    model = load_model(args.model, device=_device(args), dtype=_dtype(args.dtype))

    def dataset():
        import glob
        import os

        n = 0
        trans = glob.glob(os.path.join(args.data, "**", "*.trans.txt"), recursive=True)
        if trans:
            for tf in sorted(trans):
                root = os.path.dirname(tf)
                with open(tf) as f:
                    for line in f:
                        utt, _, text = line.strip().partition(" ")
                        for ext in (".wav", ".flac"):
                            p = os.path.join(root, utt + ext)
                            if os.path.exists(p):
                                yield p, text
                                n += 1
                                break
                        if args.limit and n >= args.limit:
                            return
        else:
            for wav in sorted(glob.glob(os.path.join(args.data, "*.wav"))):
                txt = wav[:-4] + ".txt"
                if os.path.exists(txt):
                    with open(txt) as f:
                        yield wav, f.read().strip()
                    n += 1
                    if args.limit and n >= args.limit:
                        return

    opts = TranscribeOptions(
        language=args.language, beam_size=args.beam,
        condition_on_previous_text=not args.no_condition_on_previous_text,
        without_timestamps=args.without_timestamps,
    )
    result = evaluate_dataset(model, dataset(), options=opts)
    print(json.dumps(result, indent=2))
    return 0


def _serving_model(args, device: str):
    """The checkpoint in bf16 on ``device``, with int8 decoder weights under
    --quantize and W8A8 encoder weights under --enc-int8."""
    import torch

    from .model.load import load_model
    from .model.quant import quantize_decoder_weights, quantize_encoder_weights

    model = load_model(args.model, device=device, dtype=torch.bfloat16)
    params = model.params
    if args.quantize:
        params = quantize_decoder_weights(params)
    if args.enc_int8:
        params = quantize_encoder_weights(params)
    return model.with_params(params) if params is not model.params else model


def _engine(args, model, **options):
    """The serving engine of ``args``: a BeamSlotEngine of --beam rows a
    slot, else the greedy SlotEngine."""
    from .decoding.task import DecodingOptions
    from .parallel.beam_engine import BeamSlotEngine
    from .parallel.engine import SlotEngine

    cls = BeamSlotEngine if args.beam else SlotEngine
    return cls(model, n_slots=args.slots,
               options=DecodingOptions(language=args.language, beam_size=args.beam or None,
                                       **options),
               quantize=args.quantize, audio_ctx=args.audio_ctx)


def cmd_batch(args) -> int:
    """Continuous-batching transcription of many WAVs: the native threaded
    loader decodes the files while the engine refills finished slots from
    the queue between decode chunks (--beam N: slots of N-row beam
    groups)."""
    if args.draft:
        raise _unported("batch --draft (speculative continuous batching)",
                        "parallel/spec_engine.py (ROADMAP item 14)")
    if args.tp and args.tp > 1:
        raise _unported("batch --tp", "tensor parallelism, parallel/{mesh,sharding}.py "
                        "(ROADMAP item 16)")
    from .io.wav import resample_poly
    from .runtime.native import NativeAudioLoader

    model = _serving_model(args, _device(args))
    loader = NativeAudioLoader(args.audio, n_threads=args.io_threads)
    audios = []
    for _, rate, audio in loader:
        if rate != 16000:
            audio = resample_poly(audio, 16000, rate)
        audios.append(audio)
    loader.close()
    total = sum(len(a) for a in audios) / 16000.0
    if args.long_form:
        # whisper_full through the engine: window continuation, prompt
        # carry, no-speech gate and fallback escalation per stream; --beam
        # decodes every window with beam search
        from .pipeline.transcribe import TranscribeOptions

        engine = _engine(args, model)
        t0 = time.perf_counter()
        results = engine.transcribe_streams(
            audios, TranscribeOptions(language=args.language, beam_size=args.beam or None,
                                      word_timestamps=args.word_timestamps))
        wall = time.perf_counter() - t0
        for path, res in zip(args.audio, results):
            print(f"== {path}: {res['text']}")
    else:
        engine = _engine(args, model, without_timestamps=True)
        t0 = time.perf_counter()
        results = engine.transcribe_many(audios)
        wall = time.perf_counter() - t0
        for path, res in zip(args.audio, results):
            print(f"== {path}: {res.text}")
    print(f"{total:.1f}s audio in {wall:.2f}s "
          f"({total / max(wall, 1e-9):.1f}x realtime, {args.slots} slots)")
    return 0


def cmd_serve(args) -> int:
    """HTTP transcription daemon: POST /transcribe (WAV body) -> result
    JSON, ?stream=1 NDJSON, the OpenAI audio endpoints, GET /healthz and
    /stats. Concurrent clients share the card through the
    continuous-batching engine (whisper_full long-form per request; --beam N
    serves beam groups; --dp N one engine replica per card). SIGTERM drains
    the requests in flight, then exits."""
    if args.draft:
        raise _unported("serve --draft (speculative continuous batching)",
                        "parallel/spec_engine.py (ROADMAP item 14)")
    if args.tp and args.tp > 1:
        raise _unported("serve --tp", "tensor parallelism, parallel/{mesh,sharding}.py "
                        "(ROADMAP item 16)")
    if args.profiler_port:
        raise _unported("serve --profiler-port (live device traces)",
                        "a profiler server (ROADMAP item 18)")
    import signal

    import torch

    from .parallel.server import EngineServer, MultiEngineServer, make_http_server
    from .pipeline.transcribe import TranscribeOptions

    device = _device(args)
    dp = max(1, args.dp or 1)
    devices = [device] * dp
    if dp > 1 and device.startswith("cuda"):
        # one engine replica per card
        if torch.cuda.device_count() < dp:
            raise WhisperError(f"--dp {dp} needs {dp} CUDA cards; "
                               f"{torch.cuda.device_count()} are available")
        devices = [f"cuda:{i}" for i in range(dp)]
    topts = TranscribeOptions(language=args.language, task=args.task,
                              beam_size=args.beam or None, word_timestamps=args.word_timestamps)
    servers = [EngineServer(_engine(args, _serving_model(args, dev), task=args.task), topts,
                            max_queue=args.max_queue, request_timeout_s=args.request_timeout)
               for dev in devices]
    srv_cm = servers[0] if dp == 1 else MultiEngineServer(servers)
    if args.warmup:
        for i, s in enumerate(servers):
            t0 = time.perf_counter()
            s.engine.warmup(topts)
            print(f"warmup: replica {i} ran every serving shape in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
    with srv_cm as srv:
        httpd = make_http_server(srv, args.host, args.port)
        host, port = httpd.server_address[:2]

        # SIGTERM (systemd, k8s stop): leave serve_forever on the main
        # thread; the context manager then drains the requests in flight.
        # Installed before the line below announces the server.
        def _term(signum, frame):
            raise KeyboardInterrupt

        prev = signal.signal(signal.SIGTERM, _term)
        print(f"serving on http://{host}:{port} (slots={args.slots}, "
              f"beam={args.beam or 'greedy'}, quantize={args.quantize}, replicas={dp}) - "
              f"POST /transcribe with WAV bytes", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            print("shutting down: draining in-flight requests", flush=True)
        finally:
            signal.signal(signal.SIGTERM, prev)
            httpd.server_close()
    return 0


def cmd_detect_language(args) -> int:
    """Language identification only: one encoder pass and one SOT-position
    decoder forward per file; prints the top languages with probabilities."""
    import numpy as np
    import torch

    from .config import N_SAMPLES_PER_CHUNK
    from .decoding.task import detect_language
    from .frontend.mel import frame_count, log_mel_spectrogram, mel_window
    from .io.wav import load_wav
    from .model.load import load_model

    model = load_model(args.model, device=_device(args), dtype=torch.bfloat16)
    if not model.config.is_multilingual:
        print("model is English-only (.en); language is always en")
        return 0
    for path in args.audio:
        # Pad the audio by 30 s as transcribe does: the pad must be the
        # log-mel silence floor, not mel_window's 0.0 fill.
        audio = np.pad(load_wav(path), (0, N_SAMPLES_PER_CHUNK))
        with torch.inference_mode():
            mel = log_mel_spectrogram(torch.from_numpy(audio).to(model.device), model.filters,
                                      frame_count(len(audio)))
            win = mel_window(mel, 0, 2 * model.config.n_audio_ctx)[None]
            enc = model.encoder(win)
            langs, probs = detect_language(model.decoder, model.vocab, enc.cross_k,
                                           enc.cross_v)
        top = sorted(probs[0].items(), key=lambda kv: -kv[1])[: args.top]
        ranked = ", ".join(f"{k}={v:.3f}" for k, v in top)
        print(f"== {path}: {langs[0]} ({ranked})")
    return 0


def cmd_stream(args) -> int:
    """Simulated real-time transcription: feed a WAV in chunks, print
    committed text as it stabilizes; the final output equals offline
    transcribe."""
    import numpy as np

    from .io.wav import load_wav
    from .model.load import load_model
    from .pipeline.streaming import StreamingTranscriber
    from .pipeline.transcribe import TranscribeOptions

    model = load_model(args.model, device=_device(args))
    audio = load_wav(args.audio)
    st = StreamingTranscriber(model, TranscribeOptions(language=args.language or "en"),
                              draft=not args.no_draft)
    step = int(args.chunk_seconds * 16000)
    for start in range(0, len(audio), step):
        out = st.feed(np.asarray(audio[start: start + step]))
        for seg in out["committed"]:
            print(f"[{_fmt_ts(seg['t0'])} --> {_fmt_ts(seg['t1'])}] {seg['text']}")
        if out["draft"] and args.verbose:
            tail = "".join(s["text"] for s in out["draft"])
            print(f"  (draft: {tail.strip()})")
    final = st.finalize()
    print("== final ==")
    print(final["text"])
    return 0


def cmd_bench(args) -> int:
    from .utils.benchmark import run_benchmark

    result = run_benchmark(model_path=args.model, seconds=args.seconds, batch=args.batch,
                           dtype=args.dtype, device=_device(args))
    print(json.dumps(result))
    return 0


def cmd_export(args) -> int:
    raise _unported("export (an ahead-of-time serving artifact)",
                    "a torch export of the serving step (the JAX package's utils/aot.py)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="whisper_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("transcribe", help="transcribe WAV file(s)")
    _add_transcribe_args(p)
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("info", help="inspect a GGML checkpoint")
    p.add_argument("model")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("convert", help="re-export a GGML checkpoint (f32/f16)")
    p.add_argument("model")
    p.add_argument("out")
    p.add_argument("--f16", action="store_true", help="store weights as f16")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("eval", help="WER evaluation over a dataset directory")
    p.add_argument("model")
    p.add_argument("data", help="LibriSpeech-style dir or flat wav+txt dir")
    p.add_argument("--language", default=None)
    p.add_argument("--beam", type=int, default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--no-condition-on-previous-text", action="store_true")
    p.add_argument("--without-timestamps", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("batch", help="continuous-batching engine over many WAVs")
    p.add_argument("model")
    p.add_argument("audio", nargs="+")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--language", default=None)
    p.add_argument("--quantize", action="store_true", help="int8 serving mode")
    p.add_argument("--enc-int8", action="store_true", help="W8A8 encoder matmuls")
    p.add_argument("--io-threads", type=int, default=4)
    p.add_argument("--beam", type=int, default=None,
                   help="beam size: continuous-batching beam groups")
    p.add_argument("--long-form", action="store_true",
                   help="whisper_full windows through the engine")
    p.add_argument("--word-timestamps", action="store_true")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel over this many devices")
    p.add_argument("--audio-ctx", type=int, default=None,
                   help="static encoder-context override for known-short streams")
    p.add_argument("--draft", default=None, metavar="DRAFT.npz",
                   help="speculative continuous batching with a distilled draft")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative verify width (with --draft)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("detect-language",
                       help="language identification only (first window)")
    p.add_argument("model")
    p.add_argument("audio", nargs="+")
    p.add_argument("--top", type=int, default=5,
                   help="print this many candidate languages")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_detect_language)

    p = sub.add_parser("stream", help="simulated real-time transcription")
    p.add_argument("model")
    p.add_argument("audio")
    p.add_argument("--chunk-seconds", type=float, default=5.0)
    p.add_argument("--language", default=None)
    p.add_argument("--no-draft", action="store_true")
    p.add_argument("--verbose", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("serve", help="HTTP transcription server")
    p.add_argument("model")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--language", default=None)
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--quantize", action="store_true", help="int8 serving mode")
    p.add_argument("--enc-int8", action="store_true", help="W8A8 encoder matmuls")
    p.add_argument("--beam", type=int, default=None,
                   help="beam size per stream (beam-group slots)")
    p.add_argument("--word-timestamps", action="store_true")
    p.add_argument("--max-queue", type=int, default=None,
                   help="503 new requests past this many in flight")
    p.add_argument("--audio-ctx", type=int, default=None,
                   help="static encoder-context override for known-short streams")
    p.add_argument("--draft", default=None, metavar="DRAFT.npz",
                   help="speculative continuous batching with a distilled draft")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative verify width (with --draft)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel serving over this many devices")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel serving: this many engine replicas, one a card")
    p.add_argument("--warmup", action="store_true",
                   help="run every serving program once before binding the port")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="server-side deadline in seconds per request")
    p.add_argument("--profiler-port", type=int, default=None,
                   help="serve live device traces on this port")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export", help="serialize an ahead-of-time decode program "
                                      "(not ported yet)")
    p.add_argument("model", help="GGML checkpoint path")
    p.add_argument("out", help="output artifact path")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prefill", type=int, default=32)
    p.add_argument("--sample-len", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--full-step", action="store_true",
                   help="export the full serving step (mel+encode+decode)")
    p.add_argument("--quantize", action="store_true",
                   help="int8 serving mode for --full-step")
    p.add_argument("--enc-int8", action="store_true",
                   help="W8A8 encoder for --full-step")
    p.add_argument("--flash", action="store_true",
                   help="flash-attention encoder for --full-step")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench", help="throughput benchmark")
    p.add_argument("model", nargs="?", default=None,
                   help="GGML checkpoint (default: random large-v3 weights)")
    p.add_argument("--seconds", type=int, default=120)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except WhisperError as e:
        # Typed configuration and load errors (a bad checkpoint, an oversized
        # serving config, an unported subcommand) are the user's: print the
        # message, not a traceback.
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
