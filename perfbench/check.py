"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
requests it finished (drawn from the seed, the longest always in it) is
held to the plain reference (``perfbench.reference``): for each window a
request ran, the reference encodes the window from the request's own audio
and runs the decoder over the window's prompt and served tokens; every
served token's gap below the reference's choice under openai's rules
(``reference.rules.gaps``) is read. The widest gap is ``max_gap``. The
windows' places (``served.seek_errors``), the named language served back
unchanged, and every request due in the window answered are exact checks.

The control (``control=True``) is put in the program's place: the reference
again with every int8 quantization taken to int4 and the encoder's weights
to int8. At each position of the same prompts and tokens, the token it puts
first is judged as a served token is, and its widest gap is ``max_gap``;
the program's own widest gap is kept as ``program_max_gap``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import served
from .reference.mel import log_mel, window
from .reference.model import Reference
from .reference.rules import forbidden, gaps, picks
from .reference.special import Special


def sample(done: List[dict], seed: int, min_tokens: int, max_requests: int) -> List[dict]:
    """Requests to compare: the longest, then others in an order drawn from
    the seed until ``min_tokens`` committed tokens or ``max_requests``
    requests."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 11])
    order = [done[i] for i in rng.permutation(len(done))]
    longest = max(done, key=lambda r: (r["samples"], -r["idx"]))
    picked = [longest]

    def tokens(rs):
        return sum(len(s["tokens"]) for r in rs for s in r["result"]["segments"])

    for r in order:
        if len(picked) >= max_requests or tokens(picked) >= min_tokens:
            break
        if all(r is not p for p in picked):
            picked.append(r)
    return picked


@torch.no_grad()
def readings(picked: List[dict], tree: dict, dims: dict, audio_of, device,
             control: bool = False) -> dict:
    """The numbers the limits hold, over ``picked`` (each with ``result``,
    ``samples``, ``language`` asked); ``audio_of(r)`` gives a request's PCM.
    With ``control`` the control's tokens stand where the program's were."""
    sp = Special(dims["n_vocab"])
    ref = Reference(tree, dims, bits=8)
    ctl: Optional[Reference] = Reference(tree, dims, bits=4, encoder_bits=8) if control else None
    out = {"max_gap": 0.0, "seek_errors": 0, "language_errors": 0, "tokens": 0,
           "windows": 0, "requests": len(picked)}
    program_gap = 0.0
    for r in picked:
        res, pcm = r["result"], audio_of(r)
        wins = served.windows(res)
        out["seek_errors"] += served.seek_errors(wins, len(pcm), sp.beg)
        lang = res["language"]
        if lang != r["language"] or lang not in sp.languages:
            out["language_errors"] += 1
            continue
        mel = log_mel(pcm, dims["n_mels"], device)
        for w in wins:
            if not w["tokens"]:
                continue
            init = served.initial_tokens(w["prompt"], sp.sot_sequence(lang), sp.prev,
                                         dims["n_text_ctx"])
            seq = init + w["tokens"]
            mel_w = window(mel, w["seek"])
            lg = ref.logits(seq[:-1], ref.encode(mel_w))[len(init) - 1:]
            forbid = forbidden(w["tokens"], sp, device)
            toks = torch.tensor(w["tokens"], dtype=torch.long, device=device)
            program_gap = max(program_gap, float(gaps(lg, forbid, toks, sp.beg).max()))
            if ctl is not None:
                lc = ctl.logits(seq[:-1], ctl.encode(mel_w))[len(init) - 1:]
                toks = picks(lc, forbid, sp.beg)
            out["max_gap"] = max(out["max_gap"], float(gaps(lg, forbid, toks, sp.beg).max()))
            out["tokens"] += len(w["tokens"])
            out["windows"] += 1
    if control:
        out["program_max_gap"] = program_gap
    return out
