"""Sequence decoders: greedy/temperature sampling and beam search.

Port of ``whisper_tpu/decoding/sequence.py`` (openai-whisper's
GreedyDecoder / BeamSearchDecoder / MaximumLikelihoodRanker), host numpy
between device steps, copied as it is. One difference: the JAX package's
GreedyDecoder samples at temperature > 0 with ``jax.random`` to share the
draws of its device loop; here it samples with a numpy Generator seeded
from ``seed``, so sampled tokens match JAX only in distribution.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .rules import log_softmax


class GreedyDecoder:
    """temperature == 0 -> argmax; else sample from softmax(logits / T)."""

    def __init__(self, temperature: float, eot: int, seed: int = 0):
        self.temperature = temperature
        self.eot = eot
        self._seed = int(seed)
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self._seed)

    def update(
        self, tokens: np.ndarray, logits: np.ndarray, sum_logprobs: np.ndarray
    ) -> Tuple[np.ndarray, bool]:
        """tokens (n, T), logits (n, V) -> (tokens (n, T+1), all_completed)."""
        if self.temperature == 0:
            next_tokens = logits.argmax(axis=-1)
        else:
            probs = np.exp(log_softmax(logits / self.temperature))
            next_tokens = np.array(
                [self._rng.choice(len(p), p=p / p.sum()) for p in probs]
            )
        logprobs = log_softmax(logits)
        current_logprobs = logprobs[np.arange(len(logits)), next_tokens]
        # Stop accumulating once a sequence has finished.
        not_done = tokens[:, -1] != self.eot
        sum_logprobs += current_logprobs * not_done
        next_tokens = np.where(not_done, next_tokens, self.eot)
        tokens = np.concatenate([tokens, next_tokens[:, None]], axis=-1)
        return tokens, bool((tokens[:, -1] == self.eot).all())

    def finalize(self, tokens: np.ndarray, sum_logprobs: np.ndarray):
        # make sure each sequence has at least one EOT at the end
        tokens = np.pad(tokens, ((0, 0), (0, 1)), constant_values=self.eot)
        return tokens, sum_logprobs.tolist()


class BeamSearchDecoder:
    """Beam search with openai's patience semantics.

    Group layout: the flattened batch is n_audio * beam_size rows; row
    ``i*beam_size + j`` is beam j of audio i. ``update`` returns a source-row
    index array so the caller can reorder the KV cache to match.
    """

    def __init__(self, beam_size: int, eot: int, patience: Optional[float] = None):
        self.beam_size = beam_size
        self.eot = eot
        self.patience = patience or 1.0
        self.max_candidates = round(beam_size * self.patience)
        self.finished_sequences: Optional[List[dict]] = None
        if self.max_candidates <= 0:
            raise ValueError(f"invalid beam size / patience: {beam_size}, {patience}")

    def reset(self):
        self.finished_sequences = None

    def update(
        self, tokens: np.ndarray, logits: np.ndarray, sum_logprobs: np.ndarray
    ) -> Tuple[np.ndarray, bool, np.ndarray]:
        if tokens.shape[0] % self.beam_size != 0:
            raise ValueError(f"{tokens.shape[0]} not divisible by beam {self.beam_size}")
        n_audio = tokens.shape[0] // self.beam_size
        if self.finished_sequences is None:  # first step
            self.finished_sequences = [{} for _ in range(n_audio)]

        logprobs = log_softmax(logits)
        next_tokens, source_indices, finished_sequences = [], [], []
        for i in range(n_audio):
            scores, sources, finished = {}, {}, {}
            # Collect candidates: top beam_size+1 extensions per beam.
            for j in range(self.beam_size):
                idx = i * self.beam_size + j
                prefix = tokens[idx].tolist()
                top = np.argsort(-logprobs[idx])[: self.beam_size + 1]
                for logprob, token in zip(logprobs[idx, top], top):
                    new_logprob = (sum_logprobs[idx] + logprob).item()
                    sequence = tuple(prefix + [int(token)])
                    scores[sequence] = new_logprob
                    sources[sequence] = idx
            # Keep top beam_size unfinished; route EOT-ended ones to finished.
            saved = 0
            for sequence in sorted(scores, key=scores.get, reverse=True):
                if sequence[-1] == self.eot:
                    finished[sequence] = scores[sequence]
                else:
                    sum_logprobs[len(next_tokens)] = scores[sequence]
                    next_tokens.append(sequence)
                    source_indices.append(sources[sequence])
                    saved += 1
                    if saved == self.beam_size:
                        break
            finished_sequences.append(finished)

        tokens = np.array([list(s) for s in next_tokens], dtype=tokens.dtype)
        source_indices = np.array(source_indices)

        # Add newly finished sequences (keep up to max_candidates best-first).
        for previously_finished, newly_finished in zip(
            self.finished_sequences, finished_sequences
        ):
            for seq in sorted(newly_finished, key=newly_finished.get, reverse=True):
                if len(previously_finished) >= self.max_candidates:
                    break
                previously_finished[seq] = newly_finished[seq]

        completed = all(
            len(sequences) >= self.max_candidates
            for sequences in self.finished_sequences
        )
        return tokens, completed, source_indices

    def update_from_topk(
        self,
        tokens: np.ndarray,
        top_logprobs: np.ndarray,  # (n, beam_size+1): device-side rules + top-k
        top_ids: np.ndarray,
        sum_logprobs: np.ndarray,
    ) -> Tuple[np.ndarray, bool, np.ndarray]:
        """Identical semantics to update(): openai's candidate set is exactly
        the top beam_size+1 extensions per beam."""
        if tokens.shape[0] % self.beam_size != 0:
            raise ValueError(f"{tokens.shape[0]} not divisible by beam {self.beam_size}")
        n_audio = tokens.shape[0] // self.beam_size
        if self.finished_sequences is None:
            self.finished_sequences = [{} for _ in range(n_audio)]

        next_tokens, source_indices, finished_sequences = [], [], []
        for i in range(n_audio):
            scores, sources, finished = {}, {}, {}
            for j in range(self.beam_size):
                idx = i * self.beam_size + j
                prefix = tokens[idx].tolist()
                for logprob, token in zip(top_logprobs[idx], top_ids[idx]):
                    new_logprob = (sum_logprobs[idx] + logprob).item()
                    sequence = tuple(prefix + [int(token)])
                    scores[sequence] = new_logprob
                    sources[sequence] = idx
            saved = 0
            for sequence in sorted(scores, key=scores.get, reverse=True):
                if sequence[-1] == self.eot:
                    finished[sequence] = scores[sequence]
                else:
                    sum_logprobs[len(next_tokens)] = scores[sequence]
                    next_tokens.append(sequence)
                    source_indices.append(sources[sequence])
                    saved += 1
                    if saved == self.beam_size:
                        break
            finished_sequences.append(finished)

        tokens = np.array([list(s) for s in next_tokens], dtype=tokens.dtype)
        source_indices = np.array(source_indices)
        for previously_finished, newly_finished in zip(
            self.finished_sequences, finished_sequences
        ):
            for seq in sorted(newly_finished, key=newly_finished.get, reverse=True):
                if len(previously_finished) >= self.max_candidates:
                    break
                previously_finished[seq] = newly_finished[seq]
        completed = all(
            len(sequences) >= self.max_candidates
            for sequences in self.finished_sequences
        )
        return tokens, completed, source_indices

    def finalize(self, preceding_tokens: np.ndarray, sum_logprobs: np.ndarray):
        """Collect finished sequences; pad with in-flight ones if beams ran dry."""
        sum_logprobs = sum_logprobs.copy()
        for i, sequences in enumerate(self.finished_sequences):
            if len(sequences) < self.beam_size:
                for j in np.argsort(-sum_logprobs[i * self.beam_size : (i + 1) * self.beam_size]):
                    idx = i * self.beam_size + int(j)
                    sequence = preceding_tokens[idx].tolist() + [self.eot]
                    sequences[tuple(sequence)] = sum_logprobs[idx].item()
                    if len(sequences) >= self.beam_size:
                        break
        tokens = [
            [list(seq) for seq in sequences.keys()] for sequences in self.finished_sequences
        ]
        logprobs = [list(seq.values()) for seq in self.finished_sequences]
        return tokens, logprobs


class MaximumLikelihoodRanker:
    """Pick the sample with the highest length-normalized log probability."""

    def __init__(self, length_penalty: Optional[float] = None):
        self.length_penalty = length_penalty

    def rank(self, tokens: List[List[List[int]]], sum_logprobs: List[List[float]]) -> List[int]:
        def scores(logprobs, lengths):
            result = []
            for logprob, length in zip(logprobs, lengths):
                if self.length_penalty is None:
                    penalty = length
                else:
                    penalty = ((5 + length) / 6) ** self.length_penalty
                result.append(logprob / penalty)
            return result

        lengths = [[len(t) for t in s] for s in tokens]
        return [int(np.argmax(scores(p, l))) for p, l in zip(sum_logprobs, lengths)]
