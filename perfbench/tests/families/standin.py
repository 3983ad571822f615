"""A stand-in second family for the harness's tests: Whisper's sizes,
weights and program under another name, held to a comparison of its own.

Its ``readings`` judges the served results alone: ``served_errors`` counts
the served tokens outside the vocabulary and the requests answered in
another language than the one asked."""

from perfbench import served
from perfbench.families import whisper

dims, draw, build = whisper.dims, whisper.draw, whisper.build


def readings(picked, tree, dims, audio_of, device, control=False) -> dict:
    out = {"served_errors": 0, "requests": len(picked), "windows": 0, "tokens": 0}
    for r in picked:
        res = r["result"]
        out["served_errors"] += int(res["language"] != r["language"])
        for w in served.windows(res):
            out["windows"] += 1
            out["tokens"] += len(w["tokens"])
            out["served_errors"] += sum(not 0 <= t < dims["n_vocab"] for t in w["tokens"])
    return out
