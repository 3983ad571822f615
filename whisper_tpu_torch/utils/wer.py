"""Word error rate and text normalization for evaluation harnesses.

The port's own copy of ``whisper_tpu/utils/wer.py``: Levenshtein distance
over words, after the EnglishTextNormalizer stack (``utils.normalizers``), as
openai's evaluation does; ``evaluate_dataset`` runs the port's
``pipeline.transcribe`` over (audio, reference) pairs.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from .normalizers import EnglishTextNormalizer

_normalizer = EnglishTextNormalizer()


def normalize_text(text: str) -> str:
    """openai's English normalization (see utils/normalizers.py)."""
    return _normalizer(text)


def edit_distance(ref: List[str], hyp: List[str]) -> Tuple[int, int, int, int]:
    """Returns (substitutions, deletions, insertions, distance)."""
    m, n = len(ref), len(hyp)
    # dp over (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [(i, 0, i, 0)]
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur.append(prev[j - 1])
            else:
                sub_c, sub_s, sub_d, sub_i = prev[j - 1]
                del_c, del_s, del_d, del_i = prev[j]
                ins_c, ins_s, ins_d, ins_i = cur[j - 1]
                best = min(sub_c, del_c, ins_c)
                if best == sub_c:
                    cur.append((sub_c + 1, sub_s + 1, sub_d, sub_i))
                elif best == del_c:
                    cur.append((del_c + 1, del_s, del_d + 1, del_i))
                else:
                    cur.append((ins_c + 1, ins_s, ins_d, ins_i + 1))
        prev = cur
    cost, s, d, ins = prev[n]
    return s, d, ins, cost


def wer(references: Iterable[str], hypotheses: Iterable[str],
        normalize: bool = True) -> dict:
    """Corpus-level WER over paired (reference, hypothesis) transcripts."""
    total_words = 0
    total_s = total_d = total_i = 0
    n_utts = 0
    for ref, hyp in zip(references, hypotheses):
        if normalize:
            ref, hyp = normalize_text(ref), normalize_text(hyp)
        r, h = ref.split(), hyp.split()
        s, d, i, _ = edit_distance(r, h)
        total_s += s
        total_d += d
        total_i += i
        total_words += len(r)
        n_utts += 1
    errors = total_s + total_d + total_i
    return {
        "wer": errors / max(total_words, 1),
        "substitutions": total_s,
        "deletions": total_d,
        "insertions": total_i,
        "words": total_words,
        "utterances": n_utts,
    }


def evaluate_dataset(model, dataset: Iterable[Tuple[str, str]], **transcribe_kwargs) -> dict:
    """dataset yields (wav_path_or_audio, reference_text). Runs transcribe()
    over each and reports corpus WER + RTF. The LibriSpeech harness feeds
    this directly once a corpus is available on disk."""
    import time

    from ..pipeline.transcribe import transcribe

    refs, hyps = [], []
    audio_sec = 0.0
    t0 = time.perf_counter()
    for audio, ref in dataset:
        result = transcribe(model, audio, **transcribe_kwargs)
        refs.append(ref)
        hyps.append(result["text"])
        audio_sec += result["duration"]
    wall = time.perf_counter() - t0
    out = wer(refs, hyps)
    out["rtf"] = audio_sec / wall if wall > 0 else 0.0
    out["audio_seconds"] = audio_sec
    return out
