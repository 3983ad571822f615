"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
requests it finished (drawn from the seed, the longest always in it) is
held to the plain reference of the configuration's family: the family's
``readings`` (``perfbench/families/<family>.py``) gives the numbers the
cell's limits hold. Every request due in the window answered is the
harness's own exact check (``unanswered``).
"""

from __future__ import annotations

from typing import List

import numpy as np


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

