"""What a served request's result says about the windows that made it.

A result (``{text, segments, language, duration}``) carries each segment's
window (``seek``, in mel frames) and tokens. A window's segments hold a
prefix of the tokens it decoded: every token up to its last complete
segment (openai's transcribe drops the tail after the last timestamp pair
and decodes it again in the next window). The prompt of a window is the
committed tokens of the windows before it (previous-text conditioning, never
reset here: the temperature stays 0).
"""

from __future__ import annotations

from typing import List

HOP = 160            # samples a mel frame
WINDOW_FRAMES = 3000  # 30 s of frames
INPUT_STRIDE = 2      # frames a timestamp tick


def windows(result: dict) -> List[dict]:
    """[{"seek", "prompt", "tokens"}] in the order the request ran them."""
    out: List[dict] = []
    committed: List[int] = []
    for seg in result["segments"]:
        if out and out[-1]["seek"] == seg["seek"]:
            out[-1]["tokens"].extend(int(t) for t in seg["tokens"])
            continue
        if out:
            committed.extend(out[-1]["tokens"])
        out.append({"seek": int(seg["seek"]), "prompt": list(committed),
                    "tokens": [int(t) for t in seg["tokens"]]})
    return out


def initial_tokens(prompt: List[int], sot_sequence: List[int], prev: int,
                   n_text_ctx: int) -> List[int]:
    """openai's initial tokens: <|startofprev|>, the prompt's last
    n_text_ctx // 2 - 1 tokens, then the SOT sequence (no prompt: the SOT
    sequence alone)."""
    if not prompt:
        return list(sot_sequence)
    return [prev] + list(prompt)[-(n_text_ctx // 2 - 1):] + list(sot_sequence)


def seek_errors(wins: List[dict], n_samples: int, beg: int) -> int:
    """Windows whose place breaks openai's seek rule: the first starts at 0;
    each next one starts a whole window on (``segment_size``) or at the last
    committed timestamp; the last one reaches the end of the content."""
    content = n_samples // HOP
    errors = 0 if wins and wins[0]["seek"] == 0 else 1
    for i, w in enumerate(wins):
        seek = w["seek"]
        size = min(WINDOW_FRAMES, content - seek)
        if size <= 0:
            errors += 1
            continue
        allowed = {seek + size}
        toks = w["tokens"]
        if toks and toks[-1] >= beg:
            at_ts = seek + (toks[-1] - beg) * INPUT_STRIDE
            allowed.add(at_ts if at_ts > seek else seek + size)
        nxt = wins[i + 1]["seek"] if i + 1 < len(wins) else None
        if nxt is None:
            errors += int(not any(a >= content for a in allowed))
        else:
            errors += int(nxt not in allowed)
    return errors
