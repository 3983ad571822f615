"""Transcript output writers: txt / srt / vtt / tsv.

The port's own copy of ``whisper_tpu/utils/writers.py``. Formats follow
openai's ``whisper/utils.py`` conventions exactly: SRT counts cues from 1
and uses comma decimal separators with mandatory hours; VTT uses dot
separators and omits a zero hour field; TSV is ``start\\tend\\ttext`` with
integer-millisecond times; TXT is one segment text per line.

All writers take the ``result`` dict that ``pipeline.transcribe`` returns
({"text", "segments", ...} with per-segment ``t0``/``t1`` seconds and
``text``).
"""

from __future__ import annotations

from typing import IO, Iterable


def _timestamp(seconds: float, *, always_include_hours: bool,
               decimal_marker: str) -> str:
    assert seconds >= 0, "non-negative timestamp expected"
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def write_txt(result: dict, file: IO[str]) -> None:
    for seg in result["segments"]:
        print(seg["text"].strip(), file=file, flush=True)


def _subtitle_cues(result: dict, highlight_words: bool):
    """(start, end, text) cues: one per segment, or — with
    ``highlight_words`` and word timings present — one per word with the
    current word underlined (openai's highlight_words writer option)."""
    for seg in result["segments"]:
        words = seg.get("words") or []
        if highlight_words and words:
            last = seg["t0"]
            for i, w in enumerate(words):
                start = max(last, w["start"])
                end = w["end"]
                text = "".join(
                    f" <u>{x['word'].strip()}</u>" if j == i else
                    f" {x['word'].strip()}"
                    for j, x in enumerate(words)).strip()
                yield start, end, text
                last = end
        else:
            yield seg["t0"], seg["t1"], seg["text"].strip()


def write_vtt(result: dict, file: IO[str], *,
              highlight_words: bool = False) -> None:
    print("WEBVTT\n", file=file)
    for start, end, text in _subtitle_cues(result, highlight_words):
        t0 = _timestamp(start, always_include_hours=False,
                        decimal_marker=".")
        t1 = _timestamp(end, always_include_hours=False,
                        decimal_marker=".")
        print(f"{t0} --> {t1}\n{text.replace('-->', '->')}\n",
              file=file, flush=True)


def write_srt(result: dict, file: IO[str], *,
              highlight_words: bool = False) -> None:
    for i, (start, end, text) in enumerate(
            _subtitle_cues(result, highlight_words), start=1):
        t0 = _timestamp(start, always_include_hours=True,
                        decimal_marker=",")
        t1 = _timestamp(end, always_include_hours=True,
                        decimal_marker=",")
        print(f"{i}\n{t0} --> {t1}\n{text.replace('-->', '->')}\n",
              file=file, flush=True)


def write_tsv(result: dict, file: IO[str]) -> None:
    print("start", "end", "text", sep="\t", file=file)
    for seg in result["segments"]:
        print(round(1000 * seg["t0"]), round(1000 * seg["t1"]),
              seg["text"].strip().replace("\t", " "), sep="\t",
              file=file, flush=True)


WRITERS = {"txt": write_txt, "vtt": write_vtt, "srt": write_srt,
           "tsv": write_tsv}


def write_transcripts(results: dict, output_dir: str,
                      formats: Iterable[str],
                      highlight_words: bool = False) -> list:
    """Write ``results`` ({audio_path: result}) as one file per (audio,
    format) into ``output_dir``: ``<audio_basename>.<ext>``. "json" dumps
    the full result dict; ``highlight_words`` applies to srt/vtt (needs
    word timestamps in the segments). Returns the written paths."""
    import json
    import os

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for audio_path, result in results.items():
        base = os.path.splitext(os.path.basename(audio_path))[0]
        for fmt in formats:
            out = os.path.join(output_dir, f"{base}.{fmt}")
            with open(out, "w", encoding="utf-8") as f:
                if fmt == "json":
                    json.dump(result, f, indent=2, ensure_ascii=False)
                elif fmt in ("srt", "vtt"):
                    WRITERS[fmt](result, f, highlight_words=highlight_words)
                else:
                    WRITERS[fmt](result, f)
            written.append(out)
    return written
