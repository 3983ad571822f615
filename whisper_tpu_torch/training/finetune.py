"""Fine-tuning recipe: (audio, transcript) pairs -> an updated train state.

Port of ``whisper_tpu/training/finetune.py`` for one device: transcripts
tokenized by the model's own BPE into Whisper's teacher-forcing format
[sot, (lang, task,) <|notimestamps|>?, text..., eot], audio through the
port's log-mel, batches right-padded to a 32-token bucket with loss masks,
AdamW under optax's ``warmup_cosine_decay_schedule``, periodic eval and
``torch.save`` checkpoints (``training/checkpoint.py``). A mesh raises
until the port has tensor parallelism.

Typical use:

    model = load_model("ggml-small.bin")
    state = finetune(model, train_pairs, steps=2000, batch_size=8,
                     checkpoint_dir="ckpts/")
    save_params("ckpts/final.pt", state.params)
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..frontend.mel import frame_count, log_mel_spectrogram, mel_window
from ..utils.logging import get_logger
from .train import TrainState, init_train_state, loss_fn, make_optimizer, make_train_step

log = get_logger("finetune")


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0):
    """optax's schedule of the same name: a linear ramp from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (which counts the warm-up), held after."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine decay needs positive steps, got "
                         f"{decay_steps - warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def build_target_tokens(vocab, text: str, language: str = "en",
                        task: str = "transcribe",
                        timestamps: bool = False) -> List[int]:
    """Teacher-forcing token sequence for one transcript (openai format)."""
    seq = [vocab.token_sot]
    if vocab.is_multilingual:
        seq.append(vocab.language_token(language))
        seq.append(vocab.token_translate if task == "translate"
                   else vocab.token_transcribe)
    if not timestamps:
        seq.append(vocab.token_not)
    seq.extend(vocab.encode(" " + text.strip()))
    seq.append(vocab.token_eot)
    return seq


def make_batches(
    model,
    pairs: Sequence[Tuple[np.ndarray, str]],
    batch_size: int,
    language: str = "en",
    max_tokens: int = 224,
    seed: int = 0,
    shuffle: bool = True,
):
    """Yield (mel, tokens, mask) batches forever (each epoch reshuffles),
    on the model's device: mel (B, n_mels, 2*n_audio_ctx) f32, tokens int64
    and mask int32 (B, T), T the longest sequence rounded up to 32."""
    cfg, vocab, device = model.config, model.vocab, model.device
    n_frames = 2 * cfg.n_audio_ctx
    toks = [build_target_tokens(vocab, t, language)[:max_tokens] for _, t in pairs]
    mels = []
    for audio, _ in pairs:
        audio = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
        mel = log_mel_spectrogram(audio, model.filters, frame_count(len(audio)))
        mels.append(mel_window(mel, 0, n_frames))
    rng = np.random.default_rng(seed)
    order = np.arange(len(pairs))
    T = max(len(t) for t in toks)
    T = -(-T // 32) * 32  # one bucket for every batch
    while True:
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            tok_b = np.zeros((batch_size, T), np.int64)
            mask_b = np.zeros((batch_size, T), np.int32)
            for r, j in enumerate(idx):
                tok_b[r, : len(toks[j])] = toks[j]
                mask_b[r, : len(toks[j])] = 1
            yield (torch.stack([mels[j] for j in idx]), torch.from_numpy(tok_b).to(device),
                   torch.from_numpy(mask_b).to(device))


def finetune(
    model,
    pairs: Sequence[Tuple[np.ndarray, str]],
    steps: int = 100,
    batch_size: int = 4,
    lr: float = 1e-5,
    warmup: int = 10,
    weight_decay: float = 0.01,
    language: str = "en",
    mesh=None,
    eval_pairs: Optional[Sequence[Tuple[np.ndarray, str]]] = None,
    eval_every: int = 50,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 200,
    log_every: int = 10,
    seed: int = 0,
) -> TrainState:
    """Run supervised fine-tuning on the model's device; returns the final
    TrainState (the model's own weights are left as they are)."""
    if mesh is not None:
        raise NotImplementedError("a mesh needs the port's tensor parallelism, "
                                  "which is not ported yet")
    cfg = model.config
    schedule = warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                            decay_steps=max(steps, warmup + 1))
    optimizer = make_optimizer(schedule, weight_decay=weight_decay)
    state = init_train_state(model.params, optimizer)
    train_step = make_train_step(cfg, optimizer)
    batches = make_batches(model, pairs, batch_size, language, seed=seed)

    for step in range(1, steps + 1):
        mel, tokens, mask = next(batches)
        state, loss = train_step(state, mel, tokens, mask)
        if step % log_every == 0 or step == steps:
            log.info("step %d/%d loss %.4f lr %.2e", step, steps, float(loss), schedule(step))
        if eval_pairs and step % eval_every == 0:
            ev = evaluate(model, state.params, eval_pairs, batch_size, language)
            log.info("step %d eval loss %.4f", step, ev)
        if checkpoint_dir and step % checkpoint_every == 0:
            from .checkpoint import save_train_state

            save_train_state(f"{checkpoint_dir}/step_{step}.pt", state)
    return state


@torch.no_grad()
def evaluate(model, params, pairs, batch_size: int, language: str) -> float:
    """Mean teacher-forced loss over eval pairs (single pass)."""
    cfg = model.config
    batches = make_batches(model, pairs, batch_size, language, shuffle=False)
    n = max(len(pairs) // batch_size, 1)
    total = 0.0
    for _ in range(n):
        mel, tokens, mask = next(batches)
        total += float(loss_fn(params, mel, tokens, mask, cfg))
    return total / n
