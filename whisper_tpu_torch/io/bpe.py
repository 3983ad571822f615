"""Exact GPT-2 byte-level BPE, rebuilt from the GGML vocab itself.

The port's own copy of ``whisper_tpu/io/bpe.py``, which the vocab's
non-speech token list needs on a real checkpoint. GGML checkpoints store
token byte strings in id order but no merges table. A byte-level BPE
vocab's id order is its merge creation order: token ``z`` made by merge
``r`` has id ``base + r``, and every merge in ``z``'s derivation has a
smaller id. So, walking ids in order and BPE-splitting each multi-byte token
with the merges recovered so far yields exactly two pieces, and that pair is
merge ``r``. Pre-tokenization uses GPT-2's regex, through the ``regex``
module for its ``\\p{L}``/``\\p{N}`` classes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import regex as _regex

# GPT-2 / whisper-multilingual pre-tokenizer pattern (tiktoken "gpt2").
_PAT = _regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


class ByteBPE:
    """Byte-level BPE encoder over a raw-bytes id table.

    ``id_to_token``: id -> raw token bytes (as stored in GGML files);
    ``n_text``: the number of text tokens (ids from ``n_text`` on are
    special or timestamp tokens, outside the BPE vocab).
    """

    def __init__(self, id_to_token: Dict[int, bytes], n_text: int):
        self._byte_id: Dict[int, int] = {}   # byte value -> token id
        self._ranks: Dict[Tuple[int, int], int] = {}  # (id, id) -> merged id
        self._id_to_token = id_to_token
        self._n_text = n_text
        self._build()

    def _build(self) -> None:
        for tid in range(self._n_text):
            b = self._id_to_token.get(tid)
            if b is None:
                continue
            if len(b) == 1:
                self._byte_id.setdefault(b[0], tid)

        if len(self._byte_id) < 256:
            # Not a byte-level BPE vocab (e.g. synthetic test fixtures).
            self.valid = False
            return

        skipped = 0
        for tid in range(self._n_text):
            b = self._id_to_token.get(tid)
            if b is None or len(b) < 2:
                continue
            pieces = self._merge_bytes(b)
            if pieces is not None and len(pieces) == 2:
                self._ranks[(pieces[0], pieces[1])] = tid
            else:
                # not derivable as one merge over earlier tokens (never for
                # a true BPE vocab; tolerate noise)
                skipped += 1
        self.valid = skipped < self._n_text // 100

    def _merge_bytes(self, data: bytes) -> Optional[List[int]]:
        """BPE over raw bytes using the merges recovered so far."""
        try:
            parts = [self._byte_id[c] for c in data]
        except KeyError:
            return None
        return self._merge_ids(parts)

    def _merge_ids(self, parts: List[int]) -> List[int]:
        """Repeatedly merge the adjacent pair whose merged token has the
        lowest id (= lowest merge rank)."""
        ranks = self._ranks
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [best_rank]
        return parts

    def encode(self, text: str) -> List[int]:
        """Exact GPT-2 BPE token ids for ``text`` (no special tokens)."""
        if not self.valid:
            raise ValueError("vocab is not a byte-level BPE table")
        out: List[int] = []
        for word in _PAT.findall(text):
            out.extend(self._merge_bytes(word.encode("utf-8")) or [])
        return out
