"""The Whisper family: sizes from Hugging Face's Whisper keys, the weight
tree of ``whisper_tpu_torch``'s parameters, the served program (``SlotEngine``
over a bf16 model with int8 decoder weights), and the comparison with the
plain reference (``perfbench.reference``: ``mel``, ``model``, ``rules``,
``special``). Its operation counts are ``perfbench.flops`` and its metric
arithmetic ``perfbench.layers``.

The comparison: for each window a picked request ran, the reference encodes
the window from the request's own audio and runs the decoder over the
window's prompt and served tokens; every served token's gap below the
reference's choice under openai's rules (``reference.rules.gaps``) is read.
The widest gap is ``max_gap``. The windows' places (``served.seek_errors``)
and the named language served back unchanged are exact checks.

The control (``control=True``) is put in the program's place: the reference
again with every int8 quantization taken to int4 and the encoder's weights
to int8. At each position of the same prompts and tokens, the token it puts
first is judged as a served token is, and its widest gap is ``max_gap``;
the program's own widest gap is kept as ``program_max_gap``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from perfbench import served, weights
from perfbench.reference.mel import log_mel, window
from perfbench.reference.model import Reference
from perfbench.reference.rules import forbidden, gaps, picks
from perfbench.reference.special import Special

_ENC_BLOCK = ("attn_ln_w", "attn_ln_b", "q_w", "q_b", "k_w", "v_w", "v_b", "out_w", "out_b",
              "mlp_ln_w", "mlp_ln_b", "mlp0_w", "mlp0_b", "mlp1_w", "mlp1_b")
_DEC_BLOCK = _ENC_BLOCK + ("cross_attn_ln_w", "cross_attn_ln_b", "cross_q_w", "cross_q_b",
                           "cross_k_w", "cross_v_w", "cross_v_b", "cross_out_w", "cross_out_b")


def dims(config: dict) -> Dict[str, int]:
    """The sizes the harness uses, from a configuration file's published
    Hugging Face keys."""
    p = config["published"]
    if p["encoder_attention_heads"] != p["decoder_attention_heads"]:
        raise ValueError("Whisper uses one head count in both stacks")
    if p["encoder_ffn_dim"] != 4 * p["d_model"] or p["decoder_ffn_dim"] != 4 * p["d_model"]:
        raise ValueError("Whisper's MLP is 4 x d_model wide")
    return {"n_vocab": p["vocab_size"], "n_audio_ctx": p["max_source_positions"],
            "n_state": p["d_model"], "n_head": p["encoder_attention_heads"],
            "n_audio_layer": p["encoder_layers"], "n_text_ctx": p["max_target_positions"],
            "n_text_layer": p["decoder_layers"], "n_mels": p["num_mel_bins"]}


def _block_shape(name: str, n_layer: int, a: int) -> Tuple[int, ...]:
    base = name[len("cross_"):] if name.startswith("cross_") else name
    if base in ("q_w", "k_w", "v_w", "out_w"):
        return (n_layer, a, a)
    if base == "mlp0_w":
        return (n_layer, 4 * a, a)
    if base == "mlp0_b":
        return (n_layer, 4 * a)
    if base == "mlp1_w":
        return (n_layer, a, 4 * a)
    return (n_layer, a)


def shapes(d: Dict[str, int]) -> dict:
    """The tree of shapes, keyed as the program's parameter tree: per-layer
    tensors stacked along a leading layer axis."""
    a = d["n_state"]
    return {
        "encoder": {
            "pe": (d["n_audio_ctx"], a), "conv1_w": (a, d["n_mels"], 3), "conv1_b": (a,),
            "conv2_w": (a, a, 3), "conv2_b": (a,), "ln_post_w": (a,), "ln_post_b": (a,),
            "blocks": {k: _block_shape(k, d["n_audio_layer"], a) for k in _ENC_BLOCK},
        },
        "decoder": {
            "pe": (d["n_text_ctx"], a), "te": (d["n_vocab"], a), "ln_w": (a,), "ln_b": (a,),
            "blocks": {k: _block_shape(k, d["n_text_layer"], a) for k in _DEC_BLOCK},
        },
    }


def kind(name: str) -> str:
    """How a leaf is filled: "ones" for layer-norm weights, "zeros" for
    biases, "normal" for the rest."""
    if name.endswith("ln_w") or name == "ln_post_w":
        return "ones"
    if name.endswith("_b"):
        return "zeros"
    return "normal"


def draw(d: Dict[str, int], seed: int, dtype: torch.dtype, device) -> dict:
    """The weight tree of ``d`` from ``seed`` (normal at 0.02, layer-norm
    weights one, biases zero; about forty stacked leaves)."""
    return weights.draw(shapes(d), kind, seed, dtype, device)


def build(dims: dict, tree: dict, cell: dict, device):
    """The served model (bf16, int8 decoder weights as ``cli serve
    --quantize`` loads them), its engine and the server's options."""
    from whisper_tpu_torch.config import WhisperConfig
    from whisper_tpu_torch.decoding.task import DecodingOptions
    from whisper_tpu_torch.frontend.mel import mel_filter_bank
    from whisper_tpu_torch.io.vocab import make_vocab
    from whisper_tpu_torch.model.decoder import TextDecoder
    from whisper_tpu_torch.model.encoder import AudioEncoder
    from whisper_tpu_torch.model.load import WhisperModel
    from whisper_tpu_torch.model.quant import quantize_decoder_weights
    from whisper_tpu_torch.parallel.engine import SlotEngine
    from whisper_tpu_torch.pipeline.transcribe import TranscribeOptions

    d = dims
    cfg = WhisperConfig(d["n_vocab"], d["n_audio_ctx"], d["n_state"], d["n_head"],
                        d["n_audio_layer"], d["n_text_ctx"], d["n_state"], d["n_head"],
                        d["n_text_layer"], d["n_mels"], 1).validate()
    tokens = [f"tok{i}".encode() for i in range(cfg.n_vocab)]
    filters = torch.from_numpy(mel_filter_bank(cfg.n_mels)).to(device=device,
                                                                dtype=torch.float32)
    params = quantize_decoder_weights(tree)
    model = WhisperModel(config=cfg, params=params, filters=filters,
                         vocab=make_vocab(cfg.n_vocab, tokens, cfg.n_vocab),
                         encoder=AudioEncoder(params, cfg), decoder=TextDecoder(params, cfg))
    eng = cell["engine"]
    if eng["kind"] != "slot":
        raise ValueError(f"engine kind {eng['kind']!r}: this family serves only 'slot'")
    engine = SlotEngine(model, n_slots=eng["slots"], options=DecodingOptions(),
                        chunk_steps=eng["chunk_steps"], max_new_tokens=eng["max_new_tokens"],
                        quantize=eng["quantize"])
    return engine, TranscribeOptions(**cell["options"])


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
