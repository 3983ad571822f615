"""GGML Whisper checkpoint format: reader and writer.

The port's own copy of ``whisper_tpu/io/ggml.py``'s pure-Python reader and
writer. Format:

    u32     magic = 0x67676d6c
    11*i32  hparams: n_vocab, n_audio_ctx, n_audio_state, n_audio_head,
            n_audio_layer, n_text_ctx, n_text_state, n_text_head,
            n_text_layer, n_mels, f16
    i32     filters.n_mel ; i32 filters.n_fft
    f32[n_mel*n_fft]  mel filterbank, row-major
    i32     n_vocab_in_file
    n_vocab * { u32 len ; u8[len] token_bytes }
    until fewer than 12 bytes remain:
      i32 n_dims ; i32 name_len ; i32 ftype(0=f32,1=f16)
      i32 ne[n_dims]     # ggml order: ne[0] is the fastest-varying dim
      u8[name_len] name
      raw tensor bytes (prod(ne) * 4-or-2 bytes)

All integers little-endian. A tensor with ggml ne=(a, b, c) is a C-contiguous
numpy array of shape (c, b, a). The reader checks names, shapes and sizes
against the schema the header implies.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple

import numpy as np

from ..config import WhisperConfig
from ..errors import (
    BadMagicError,
    TruncatedFileError,
    UnknownTensorError,
    UnsupportedFtypeError,
    WrongBytesTensorError,
    WrongShapeTensorError,
    WrongSizeTensorError,
)
from .vocab import WhisperVocab, make_vocab

GGML_MAGIC = 0x67676D6C


@dataclasses.dataclass
class GGMLCheckpoint:
    """Parsed checkpoint: config + mel filterbank + vocab + named weights."""

    config: WhisperConfig
    filters: np.ndarray  # (n_mel, n_fft_bins) f32
    vocab: WhisperVocab
    tensors: Dict[str, np.ndarray]  # name -> numpy array (f32 or f16)


def tensor_schema(config: WhisperConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (numpy shape, dtype kind: 'w' = header wtype, 'f32' = always f32).

    Conv biases are stored 2-D as (n_state, 1) in the file.
    """
    c = config
    a, t, v, m = c.n_audio_state, c.n_text_state, c.n_vocab, c.n_mels
    s: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "encoder.positional_embedding": ((c.n_audio_ctx, a), "f32"),
        "encoder.conv1.weight": ((a, m, 3), "w"),
        "encoder.conv1.bias": ((a, 1), "f32"),
        "encoder.conv2.weight": ((a, a, 3), "w"),
        "encoder.conv2.bias": ((a, 1), "f32"),
        "encoder.ln_post.weight": ((a,), "f32"),
        "encoder.ln_post.bias": ((a,), "f32"),
        "decoder.positional_embedding": ((c.n_text_ctx, t), "f32"),
        "decoder.token_embedding.weight": ((v, t), "w"),
        "decoder.ln.weight": ((t,), "f32"),
        "decoder.ln.bias": ((t,), "f32"),
    }
    for i in range(c.n_audio_layer):
        p = f"encoder.blocks.{i}."
        s[p + "mlp_ln.weight"] = ((a,), "f32")
        s[p + "mlp_ln.bias"] = ((a,), "f32")
        s[p + "mlp.0.weight"] = ((4 * a, a), "w")
        s[p + "mlp.0.bias"] = ((4 * a,), "f32")
        s[p + "mlp.2.weight"] = ((a, 4 * a), "w")
        s[p + "mlp.2.bias"] = ((a,), "f32")
        s[p + "attn_ln.weight"] = ((a,), "f32")
        s[p + "attn_ln.bias"] = ((a,), "f32")
        s[p + "attn.query.weight"] = ((a, a), "w")
        s[p + "attn.query.bias"] = ((a,), "f32")
        s[p + "attn.key.weight"] = ((a, a), "w")
        s[p + "attn.value.weight"] = ((a, a), "w")
        s[p + "attn.value.bias"] = ((a,), "f32")
        s[p + "attn.out.weight"] = ((a, a), "w")
        s[p + "attn.out.bias"] = ((a,), "f32")
    for i in range(c.n_text_layer):
        p = f"decoder.blocks.{i}."
        s[p + "mlp_ln.weight"] = ((t,), "f32")
        s[p + "mlp_ln.bias"] = ((t,), "f32")
        s[p + "mlp.0.weight"] = ((4 * t, t), "w")
        s[p + "mlp.0.bias"] = ((4 * t,), "f32")
        s[p + "mlp.2.weight"] = ((t, 4 * t), "w")
        s[p + "mlp.2.bias"] = ((t,), "f32")
        s[p + "attn_ln.weight"] = ((t,), "f32")
        s[p + "attn_ln.bias"] = ((t,), "f32")
        s[p + "attn.query.weight"] = ((t, t), "w")
        s[p + "attn.query.bias"] = ((t,), "f32")
        s[p + "attn.key.weight"] = ((t, t), "w")
        s[p + "attn.value.weight"] = ((t, t), "w")
        s[p + "attn.value.bias"] = ((t,), "f32")
        s[p + "attn.out.weight"] = ((t, t), "w")
        s[p + "attn.out.bias"] = ((t,), "f32")
        s[p + "cross_attn_ln.weight"] = ((t,), "f32")
        s[p + "cross_attn_ln.bias"] = ((t,), "f32")
        s[p + "cross_attn.query.weight"] = ((t, t), "w")
        s[p + "cross_attn.query.bias"] = ((t,), "f32")
        s[p + "cross_attn.key.weight"] = ((t, t), "w")
        s[p + "cross_attn.value.weight"] = ((t, t), "w")
        s[p + "cross_attn.value.bias"] = ((t,), "f32")
        s[p + "cross_attn.out.weight"] = ((t, t), "w")
        s[p + "cross_attn.out.bias"] = ((t,), "f32")
    return s


def _read_i32(buf: memoryview, off: int) -> Tuple[int, int]:
    if off + 4 > len(buf):
        raise TruncatedFileError(f"file truncated at offset {off}")
    return struct.unpack_from("<i", buf, off)[0], off + 4


def _parse_header(buf, path: str) -> WhisperConfig:
    """The magic and the 11-field hparams header at the start of ``buf``."""
    if len(buf) < 4:
        raise TruncatedFileError(f"file truncated at offset 0 ({path!r})")
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != GGML_MAGIC:
        raise BadMagicError(path, magic)
    if 4 + 44 > len(buf):
        raise TruncatedFileError("file truncated in the hparams header")
    return WhisperConfig(*struct.unpack_from("<11i", buf, 4)).validate()


def read_ggml_config(path: str) -> WhisperConfig:
    """A checkpoint's config from its header alone (no tensor is read)."""
    with open(path, "rb") as f:
        return _parse_header(f.read(48), path)


def load_ggml(path: str, verbose: bool = True) -> GGMLCheckpoint:
    """Parse a GGML Whisper checkpoint into numpy arrays (zero-copy views
    into the file's bytes)."""
    from ..utils.logging import get_logger

    log = get_logger("ggml")
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    config = _parse_header(buf, path)
    off = 48
    if verbose:
        log.info("model type   = %s", config.model_type)
        for field in dataclasses.fields(WhisperConfig)[:11]:
            log.info("%-14s = %d", field.name, getattr(config, field.name))
        log.info("hbm estimate = %.2f MB", config.hbm_bytes_estimate() / 2**20)

    n_mel, off = _read_i32(buf, off)
    n_fft_bins, off = _read_i32(buf, off)
    n = n_mel * n_fft_bins
    if off + 4 * n > len(buf):
        raise TruncatedFileError("file truncated in the mel filterbank")
    filters = np.frombuffer(buf, dtype="<f4", count=n, offset=off).reshape(
        n_mel, n_fft_bins
    ).copy()
    off += 4 * n

    n_vocab_file, off = _read_i32(buf, off)
    tokens: List[bytes] = []
    for _ in range(n_vocab_file):
        ln, off = _read_i32(buf, off)
        if ln < 0 or off + ln > len(buf):
            raise TruncatedFileError(
                f"file truncated in vocab entry {len(tokens)}")
        tokens.append(bytes(buf[off : off + ln]))
        off += ln
    vocab = make_vocab(config.n_vocab, tokens, n_vocab_file)

    schema = tensor_schema(config)
    wtype = np.float16 if config.f16 == 1 else np.float32

    tensors: Dict[str, np.ndarray] = {}
    total_bytes = 0
    while len(buf) - off >= 12:
        n_dims, off = _read_i32(buf, off)
        name_len, off = _read_i32(buf, off)
        ftype, off = _read_i32(buf, off)
        ne = []
        for _ in range(n_dims):
            d, off = _read_i32(buf, off)
            ne.append(d)
        if name_len < 0 or off + name_len > len(buf):
            raise TruncatedFileError("file truncated in a tensor name")
        name = bytes(buf[off : off + name_len]).decode("utf-8")
        off += name_len

        # f32 (0) or f16 (1) only: a later quantized ggml type would pass
        # the byte check as f16 and desync the stream.
        if ftype not in (0, 1):
            raise UnsupportedFtypeError(name, ftype)
        if name not in schema:
            raise UnknownTensorError(name)
        exp_shape, kind = schema[name]
        nelements = int(np.prod(ne))
        exp_n = int(np.prod(exp_shape))
        if nelements != exp_n:
            raise WrongSizeTensorError(name, exp_n, nelements)
        np_shape = tuple(reversed(ne))  # ggml ne order is reversed numpy order
        if np_shape != tuple(exp_shape):
            raise WrongShapeTensorError(name, np_shape, exp_shape)

        dt = np.float32 if ftype == 0 else np.float16
        exp_dt = np.float32 if kind == "f32" else wtype
        nbytes = nelements * dt().itemsize
        if nbytes != nelements * exp_dt().itemsize:
            raise WrongBytesTensorError(name, nelements * exp_dt().itemsize, nbytes)
        if off + nbytes > len(buf):
            raise TruncatedFileError(f"tensor {name!r} data truncated")
        arr = np.frombuffer(buf, dtype=dt, count=nelements, offset=off).reshape(np_shape)
        tensors[name] = arr  # zero-copy view into the file buffer
        off += nbytes
        total_bytes += nbytes

    missing = set(schema) - set(tensors)
    if missing:
        raise TruncatedFileError(
            f"checkpoint missing {len(missing)} tensors, e.g. {sorted(missing)[:4]}"
        )
    if verbose:
        log.info("model size   = %7.2f MB (%d tensors)", total_bytes / 2**20, len(tensors))
    return GGMLCheckpoint(config=config, filters=filters, vocab=vocab, tensors=tensors)


def write_ggml(
    path: str,
    config: WhisperConfig,
    filters: np.ndarray,
    tokens: List[bytes],
    tensors: Dict[str, np.ndarray],
) -> None:
    """Write a GGML checkpoint (inverse of load_ggml), for synthetic
    checkpoints and re-export."""
    schema = tensor_schema(config)
    wtype = np.float16 if config.f16 == 1 else np.float32
    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGML_MAGIC))
        f.write(
            struct.pack(
                "<11i",
                config.n_vocab,
                config.n_audio_ctx,
                config.n_audio_state,
                config.n_audio_head,
                config.n_audio_layer,
                config.n_text_ctx,
                config.n_text_state,
                config.n_text_head,
                config.n_text_layer,
                config.n_mels,
                config.f16,
            )
        )
        f.write(struct.pack("<2i", filters.shape[0], filters.shape[1]))
        f.write(np.ascontiguousarray(filters, dtype="<f4").tobytes())
        f.write(struct.pack("<i", len(tokens)))
        for tok in tokens:
            f.write(struct.pack("<I", len(tok)))
            f.write(tok)
        for name, (exp_shape, kind) in schema.items():
            arr = tensors[name]
            if tuple(arr.shape) != tuple(exp_shape):
                raise WrongShapeTensorError(name, arr.shape, exp_shape)
            dt = np.float32 if kind == "f32" else wtype
            arr = np.ascontiguousarray(arr, dtype=dt)
            ne = tuple(reversed(arr.shape))  # ggml order
            ftype = 0 if dt == np.float32 else 1
            name_b = name.encode("utf-8")
            f.write(struct.pack("<3i", len(ne), len(name_b), ftype))
            f.write(struct.pack(f"<{len(ne)}i", *ne))
            f.write(name_b)
            f.write(arr.tobytes())
