"""Weights-free code embedder ``code-hash-384`` (port of
``codesearch_tpu/models/hash_embedder.py``).

A text embeds as the L2-normalized weighted sum of hash-table rows, one row
per code feature (subwords, whole identifiers, adjacent-token bigrams). The
table is the JAX package's: ``jax.random.normal(PRNGKey(TABLE_SEED),
(65536, d)) / sqrt(d)`` rounded to bf16. ``make_table_bits`` regenerates it
in numpy with no JAX: threefry-2x32 with partitionable counters, JAX's
uniform mapping, and the float32 ``erf_inv`` that XLA's CPU backend lowers
(Giles' polynomial over a Cephes ``log1p``/``log``, with the fused
multiply-adds XLA emits). The bits equal ``make_table(384)`` of the JAX
package on its CPU backend in every entry, so both packages embed alike and
read each other's indexes. Generation takes tens of seconds on one core, so
the bf16 bits are cached under the config dir.

Featurization is the JAX package's algorithm, byte for byte, through the
shared native library when it loads and in Python otherwise.
"""

from __future__ import annotations

import math
import os
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from codesearch_tpu.models.tokenizer import code_tokens
from codesearch_tpu.utils.hashing import stable_u64

from ..utils.device import resolve_device

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
# XLA's float32 erf_inv (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p for |x| < sqrt(2) - 1 (Cephes rational approximation)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: the float64 product of two float32 values
    is exact, so one rounding of the float64 sum back to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds (jax.random's ``threefry_2x32``)."""
    ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _uniform_open(bits: np.ndarray) -> np.ndarray:
    """jax.random.uniform(minval=nextafter(-1, 0), maxval=1) of 32 bits."""
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - _F32(1.0)
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=np.float32)
    return np.maximum(lo, f * _F32(2.0) + lo)   # maxval - minval == 2.0 in f32


def _log_xla(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 log (Cephes polynomial, split ln 2)."""
    x = np.maximum(x, _U32(0x00800000).view(np.float32))
    u = x.view(np.uint32)
    e = _F32(1.0) + ((u >> _U32(23)).astype(np.int32) - 0x7F).astype(np.float32)
    m = ((u & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(np.float32)
    small = m < _F32(0.707106781186547524)
    e = e - small.astype(np.float32)
    m = (m - _F32(1.0)) + np.where(small, m, _F32(0.0))
    x2 = m * m
    x3 = x2 * m
    y = _fma(m, _F32(7.0376836292e-2), _F32(-1.1514610310e-1))
    y1 = _fma(m, _F32(-1.2420140846e-1), _F32(1.4249322787e-1))
    y2 = _fma(m, _F32(2.0000714765e-1), _F32(-2.4999993993e-1))
    y = _fma(y, m, _F32(1.1676998740e-1))
    y1 = _fma(y1, m, _F32(-1.6668057665e-1))
    y2 = _fma(y2, m, _F32(3.3333331174e-1))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _F32(-2.12194440e-4))
    m = m - x2 * _F32(0.5)
    return (m + y) + e * _F32(0.693359375)


def _log1p_xla(x: np.ndarray) -> np.ndarray:
    def poly(coeffs):
        r = np.zeros_like(x)
        for c in coeffs:
            r = _fma(r, x, _F32(c))
        return r

    x2 = x * x
    small = x + (_F32(-0.5) * x2 + (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    _log_xla(x + _F32(1.0)))


def _erf_inv_xla(x: np.ndarray) -> np.ndarray:
    w = -_log1p_xla(-(x * x))
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(np.float32)
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0])).astype(np.float32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(lo), _F32(hi)))
    return p * x


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
    sqrt2 = _F32(np.sqrt(2))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for a in range(0, n, block):
            b = min(n, a + block)
            b1, b2 = _threefry2x32(0, TABLE_SEED, np.zeros(b - a, np.uint32),
                                   np.arange(a, b, dtype=np.uint32))
            normal = sqrt2 * _erf_inv_xla(_uniform_open(b1 ^ b2))
            out[a:b] = _bf16_bits(normal / scale)
    return out


def _table_bits_path(dims: int, buckets: int) -> Path:
    from codesearch_tpu.utils.constants import get_config_dir

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

def _native_lib():
    from codesearch_tpu.native import _load

    return _load()


def _featurize_native(text: str):
    import ctypes

    lib = _native_lib()
    if lib is None:
        return None
    raw = text.encode("utf-8", errors="replace")
    cap = 2 * len(raw) + 16
    ids = np.empty(cap, np.int64)
    ws = np.empty(cap, np.float64)
    n = lib.cs_featurize(
        raw, len(raw), VOCAB_BUCKETS,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
    )
    if n < 0:
        return None
    return ids[:n].copy(), ws[:n].astype(np.float32)


def _featurize_batch_native(texts: list[str]):
    import ctypes

    lib = _native_lib()
    if lib is None:
        return None
    raws = [t.encode("utf-8", errors="replace") for t in texts]
    long_t = np.int64 if ctypes.sizeof(ctypes.c_long) == 8 else np.int32
    offs = np.zeros(len(raws) + 1, long_t)
    offs[1:] = np.cumsum([len(r) for r in raws])
    total = int(offs[-1])
    cap = 2 * total + 16 * max(len(raws), 1)
    ids = np.empty(cap, np.int64)
    ws = np.empty(cap, np.float64)
    counts = np.zeros(len(raws), long_t)
    n = lib.cs_featurize_batch(
        b"".join(raws), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(raws), VOCAB_BUCKETS,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if n < 0:
        return None
    out, pos = [], 0
    for c in counts.tolist():
        out.append((ids[pos:pos + c].copy(), ws[pos:pos + c].astype(np.float32)))
        pos += c
    return out


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
