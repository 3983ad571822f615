"""Traffic from a mix file and a seed: clip lengths, languages and the audio
itself.

One general generator reads every mix (``perfbench/workloads/<cell>.json``,
key ``traffic``). Draws are stratified: each block of ``block`` requests
takes the same multiset of lengths and languages (the distribution's
quantiles at (k + 0.5) / block), in an order the seed shuffles, so two
seeds offer the same work in another order.

Lengths (``lengths.law``): ``uniform``, ``low_s`` .. ``high_s``.
Arrivals (``loop``): ``closed`` keeps ``outstanding`` requests in flight.
``language_share`` maps a language to its share of requests.

The audio is one int16 bank made from the seed (noise under a syllable-rate
envelope, with a few tones); a request is a slice of it at an offset the
seed draws. Nothing is read from disk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

SAMPLE_RATE = 16000


@dataclass(frozen=True)
class Request:
    idx: int
    samples: int             # clip length in samples
    offset: int              # start in the audio bank
    language: str

    @property
    def seconds(self) -> float:
        return self.samples / SAMPLE_RATE


def _quantiles(law: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    if law["law"] == "uniform":
        return law["low_s"] + u * (law["high_s"] - law["low_s"])
    raise ValueError(f"unknown length law {law['law']!r}")


def _languages(share: dict, n: int) -> List[str]:
    out: List[str] = []
    for lang, frac in sorted(share.items()):
        out += [lang] * int(round(frac * n))
    if len(out) != n:
        raise ValueError(f"language shares {share} do not split a block of {n} exactly")
    return out


class Traffic:
    """The request stream of one mix and seed; ``request(i)`` is the i-th."""

    def __init__(self, mix: dict, seed: int):
        if mix["loop"] != "closed":
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.mix = mix
        self.block = int(mix["block"])
        self.rng_seed = int(seed)
        self.lengths_s = _quantiles(mix["lengths"], self.block)
        self.langs = _languages(mix["language_share"], self.block)
        self.bank = make_bank(seed, float(mix["bank_s"]))
        self._blocks: dict = {}

    def _block(self, b: int):
        if b not in self._blocks:
            rng = np.random.default_rng([self.rng_seed, b])
            self._blocks[b] = (rng.permutation(self.block), rng.permutation(self.block),
                               rng.random(self.block))
        return self._blocks[b]

    def request(self, i: int) -> Request:
        b, k = divmod(i, self.block)
        p_len, p_lang, u_off = self._block(b)
        samples = int(round(float(self.lengths_s[p_len[k]]) * SAMPLE_RATE))
        offset = int(u_off[k] * (len(self.bank) - samples))
        return Request(idx=i, samples=samples, offset=offset, language=self.langs[p_lang[k]])

    def audio(self, r: Request) -> np.ndarray:
        """The request's int16 PCM, a view of the bank."""
        return self.bank[r.offset: r.offset + r.samples]


def make_bank(seed: int, seconds: float) -> np.ndarray:
    """``seconds`` of int16 audio from ``seed``: noise under a 4 Hz envelope
    with three tones whose pitches the seed draws."""
    rng = np.random.default_rng([int(seed), 7])
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n, dtype=np.float32) / SAMPLE_RATE
    env = 0.55 + 0.45 * np.sin(2 * math.pi * 4.0 * t + rng.uniform(0, 2 * math.pi))
    x = rng.standard_normal(n).astype(np.float32) * 0.08 * env
    for f in rng.uniform(150.0, 900.0, size=3):
        x += 0.05 * np.sin(2 * math.pi * float(f) * t).astype(np.float32) * env
    return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
