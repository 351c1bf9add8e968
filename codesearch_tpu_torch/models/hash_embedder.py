"""Weights-free code embedder ``code-hash-384`` (port of
``codesearch_tpu/models/hash_embedder.py``).

A text embeds as the L2-normalized weighted sum of hash-table rows, one row
per code feature (subwords, whole identifiers, adjacent-token bigrams). The
table is the JAX package's: ``jax.random.normal(PRNGKey(TABLE_SEED),
(65536, d)) / sqrt(d)`` rounded to bf16. ``make_table_bits`` regenerates it
in numpy with no JAX (``jax_random``). The bits equal ``make_table(384)``
of the JAX package on its CPU backend in every entry, so both packages
embed alike and read each other's indexes. Generation takes tens of seconds
on one core, so the bf16 bits are cached under the config dir.

Featurization is the JAX package's algorithm, byte for byte, through the
port's native library (``native/``) when it loads and in Python otherwise.
"""

from __future__ import annotations

import math
import os
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..native import _featurize_impl as _featurize_native
from ..native import featurize_batch_native as _featurize_batch_native
from ..utils.constants import get_config_dir
from ..utils.device import resolve_device
from ..utils.hashing import stable_u64
from .jax_random import normal_f32, prng_key
from .tokenizer import code_tokens

VOCAB_BUCKETS = 1 << 16
TABLE_SEED = 0xC0DE5EA
_BIGRAM_WEIGHT = 0.7
_WHOLE_IDENT_WEIGHT = 1.5
MAX_TOKENS = 512

# ---------------------------------------------------------------------------
# the default table, regenerated in numpy
# ---------------------------------------------------------------------------

_U32 = np.uint32
_F32 = np.float32


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, round to nearest even (finite inputs)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + _U32(0x7FFF) + ((u >> _U32(16)) & _U32(1))) >> _U32(16)).astype(np.uint16)


def make_table_bits(dims: int, buckets: int = VOCAB_BUCKETS,
                    block: int = 1 << 20) -> np.ndarray:
    """bf16 bits [buckets * dims] of the default table, computed in numpy."""
    n = buckets * dims
    out = np.empty(n, np.uint16)
    scale = _F32(math.sqrt(dims))
    key = prng_key(TABLE_SEED)
    for a in range(0, n, block):
        b = min(n, a + block)
        out[a:b] = _bf16_bits(normal_f32(key, b - a, a) / scale)
    return out


def _table_bits_path(dims: int, buckets: int) -> Path:
    return get_config_dir() / f"hash_table_{TABLE_SEED:08x}_{buckets}x{dims}.torch.u16"


def default_table_bits(dims: int, buckets: int = VOCAB_BUCKETS) -> np.ndarray:
    """The default table's bf16 bits, from the cache or generated (and then
    cached with an atomic best-effort write)."""
    path = _table_bits_path(dims, buckets)
    try:
        bits = np.fromfile(path, np.uint16)
        if bits.size == buckets * dims:
            return bits
    except OSError:
        pass
    bits = make_table_bits(dims, buckets)
    tmp = Path(f"{path}.{os.getpid()}.tmp")
    try:
        bits.tofile(tmp)
        os.replace(tmp, path)
    except OSError:
        pass
    return bits


def _bits_to_tensor(bits: np.ndarray, shape) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).reshape(shape).copy()).view(torch.bfloat16)


def make_table(dims: int, buckets: int = VOCAB_BUCKETS, device=None) -> torch.Tensor:
    """The default [buckets, dims] bf16 table on ``device``."""
    bits = default_table_bits(dims, buckets)
    return _bits_to_tensor(bits, (buckets, dims)).to(resolve_device(device))


def table_from_jax(np_table: np.ndarray) -> torch.Tensor:
    """A table from the JAX package (``np.asarray`` of a bf16 or f32 jax
    array) as a CPU bf16 tensor with the same values."""
    arr = np.asarray(np_table)
    if arr.dtype.name == "bfloat16":
        return _bits_to_tensor(arr.view(np.uint16), arr.shape)
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(torch.bfloat16)


def _round_bf16_f32(x: np.ndarray) -> np.ndarray:
    """Round float32 to the nearest bf16, kept as float32."""
    return (_bf16_bits(x).astype(np.uint32) << _U32(16)).view(np.float32).reshape(np.shape(x))


def load_table_host(path, dims: int) -> np.ndarray | None:
    """A fine-tuned table (``<db>/hash_table.npz``) as bf16-rounded host f32;
    None when missing or invalid (the caller then uses the default)."""
    try:
        data = np.load(str(path))["table"].astype(np.float32)
    except (OSError, KeyError, ValueError):
        return None
    if data.ndim != 2 or data.shape[1] != dims:
        return None
    return _round_bf16_f32(data)


# ---------------------------------------------------------------------------
# featurization (host)
# ---------------------------------------------------------------------------

def _featurize_py(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Pure-Python featurization: subword unigrams (w = 1+ln tf, x1.5 for
    whole identifiers), then adjacent-token bigrams (w = 0.7(1+ln tf)), in
    first-occurrence order."""
    toks = code_tokens(text)
    feats: Counter[int] = Counter()
    whole: set[int] = set()
    for t in toks:
        b = stable_u64(t) % VOCAB_BUCKETS
        feats[b] += 1
        if "_" in t or len(t) > 12:
            whole.add(b)
    bigrams: Counter[int] = Counter()
    for a, b2 in zip(toks, toks[1:]):
        bigrams[stable_u64(a + "\x1f" + b2) % VOCAB_BUCKETS] += 1
    ids: list[int] = []
    ws: list[float] = []
    for b, tf in feats.items():
        w = 1.0 + math.log(tf)
        if b in whole:
            w *= _WHOLE_IDENT_WEIGHT
        ids.append(b)
        ws.append(w)
    for b, tf in bigrams.items():
        ids.append(b)
        ws.append(_BIGRAM_WEIGHT * (1.0 + math.log(tf)))
    return np.asarray(ids, np.int64), np.asarray(ws, np.float32)


def _cap_features(ids: np.ndarray, ws: np.ndarray, max_tokens: int):
    """Empty texts get one zero-weight feature; long ones keep their
    ``max_tokens`` highest weights (stable on ties) in original order."""
    if ids.size == 0:
        return np.zeros(1, np.int32), np.zeros(1, np.float32)
    if ids.size > max_tokens:
        order = np.argsort(-ws, kind="stable")[:max_tokens]
        order.sort()
        ids = ids[order]
        ws = ws[order]
    return ids.astype(np.int32), ws


def featurize(text: str, max_tokens: int = MAX_TOKENS) -> tuple[np.ndarray, np.ndarray]:
    """(bucket_ids [T], weights [T]) of one text."""
    result = _featurize_native(text)
    if result is None:
        result = _featurize_py(text)
    return _cap_features(*result, max_tokens)


def batch_features(texts: list[str], max_tokens: int = MAX_TOKENS):
    """[B, T] bucket ids + weights (zero-weight padding), T a power of two
    >= 16 capped at ``max_tokens``: the JAX package's shapes."""
    raw = _featurize_batch_native(texts) if texts else None
    if raw is not None:
        pairs = [_cap_features(i, w, max_tokens) for i, w in raw]
    else:
        pairs = [featurize(t, max_tokens) for t in texts]
    t_max = max((len(i) for i, _ in pairs), default=1)
    t_max = min(1 << max(4, (t_max - 1).bit_length()), max_tokens)
    ids = np.zeros((len(texts), t_max), np.int32)
    ws = np.zeros((len(texts), t_max), np.float32)
    for row, (i, w) in enumerate(pairs):
        m = min(len(i), t_max)
        ids[row, :m] = i[:m]
        ws[row, :m] = w[:m]
    return ids, ws


# ---------------------------------------------------------------------------
# device embedding
# ---------------------------------------------------------------------------

def embed_features(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[B, T] bucket ids + weights -> [B, d] L2-normalized f32 embeddings:
    a row gather from the bf16 table, an f32 weighted sum, an L2 norm."""
    rows = table[ids.long()].float()                               # [B, T, d]
    vec = torch.bmm(weights.float().unsqueeze(1), rows).squeeze(1)  # [B, d]
    return vec / torch.clamp(torch.linalg.vector_norm(vec, dim=-1, keepdim=True), min=1e-12)


class HashEmbedder:
    """Holds the table on ``device``. ``table`` overrides the default table
    (tests hand over the JAX package's); ``table_path`` loads a fine-tuned
    one."""

    def __init__(self, dims: int, table: torch.Tensor | None = None,
                 table_path=None, device=None):
        self.dims = dims
        self.device = resolve_device(device)
        self._host_table: np.ndarray | None = None
        host = load_table_host(table_path, dims) if table_path is not None else None
        if table is not None:
            self.table = table.to(device=self.device, dtype=torch.bfloat16)
        elif host is not None:
            self._host_table = host
            self.table = torch.from_numpy(host).to(torch.bfloat16).to(self.device)
        else:
            self.table = make_table(dims, device=self.device)

    def table_np(self) -> np.ndarray:
        """Host f32 twin of the table (the same bf16 values), for the
        store's small-corpus host path."""
        if self._host_table is None:
            self._host_table = self.table.float().cpu().numpy()
        return self._host_table

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dims), np.float32)
        ids, ws = batch_features(texts)
        out = embed_features(self.table, torch.from_numpy(ids).to(self.device),
                             torch.from_numpy(ws).to(self.device))
        return out.cpu().numpy()
