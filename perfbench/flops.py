"""Operations and bytes of the work a window needs, from the model's shapes.

Counts are of what the inputs need: a window encoded at its 1500 positions,
the prompt and the committed tokens of a window decoded at their own
positions with cross attention over 1500, logits for each sampled token.
A multiply-add is two operations.
"""

from __future__ import annotations


def k1_flops(rows: int, t_q: int, t_k: int, d: int) -> float:
    """Unmasked attention over ``rows`` (batch x heads) heads: QK^T and PV."""
    return 4.0 * rows * t_q * t_k * d


def k1_bytes(rows: int, t_q: int, t_k: int, d: int, esize: int = 2) -> float:
    """q and out, k and v, each read or written once."""
    return float(esize * rows * d * (2 * t_q + 2 * t_k))


def k4_bytes(batch: int, heads: int, t_q: int, d: int, keys: float) -> float:
    """int8 attention: int8 K and V and their f32 per-position scales for
    ``keys`` positions a row, q and out in bf16."""
    kv = 2.0 * batch * heads * keys * d + 2.0 * batch * heads * keys * 4
    return kv + 2.0 * 2 * batch * heads * t_q * d


def k4_flops(batch: int, heads: int, t_q: int, d: int, keys: float) -> float:
    return 4.0 * batch * heads * t_q * keys * d


def encoder_flops(dims: dict) -> float:
    """One window through the conv stem, every encoder block and the cross
    keys and values of every decoder layer."""
    a, t, m = dims["n_state"], dims["n_audio_ctx"], dims["n_mels"]
    stem = 2.0 * (2 * t) * m * 3 * a + 2.0 * t * a * 3 * a
    block = 2.0 * t * a * a * 4 + 2.0 * t * a * 4 * a * 2 + k1_flops(1, t, t, a)
    cross = 2.0 * t * a * a * 2 * dims["n_text_layer"]
    return stem + dims["n_audio_layer"] * block + cross


def decoder_token_flops(dims: dict, position: int, logits: bool) -> float:
    """One token at ``position`` (it sees position + 1 keys) through every
    decoder layer, with the vocabulary's logits when ``logits``."""
    a = dims["n_state"]
    per_layer = (2.0 * a * a * 6 + 2.0 * a * 4 * a * 2
                 + 4.0 * a * (position + 1) + 4.0 * a * dims["n_audio_ctx"])
    return dims["n_text_layer"] * per_layer + (2.0 * a * dims["n_vocab"] if logits else 0.0)


def window_flops(dims: dict, prompt_len: int, n_tokens: int) -> float:
    """A window: its encode, its prompt prefilled (logits at its last
    position), and ``n_tokens`` sampled tokens, each with logits."""
    total = encoder_flops(dims)
    for p in range(prompt_len):
        total += decoder_token_flops(dims, p, logits=p == prompt_len - 1)
    for i in range(n_tokens):
        total += decoder_token_flops(dims, prompt_len + i, logits=True)
    return total
