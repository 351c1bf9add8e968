"""JAX's default random stream, regenerated in numpy with no JAX.

``jax.random`` with threefry-2x32 and partitionable counters (JAX's default):
a key is two uint32 words; ``split(key, n)`` hashes the counters
``(0, i)`` for ``i < n``; ``fold_in(key, d)`` hashes the seed words
``(0, d)``; ``normal(key, shape)`` hashes ``(0, i)`` for each
flat index, maps the xor of the two output words to a uniform in
``(nextafter(-1, 0), 1)`` and returns ``sqrt(2) * erf_inv(u)`` with the
float32 ``erf_inv`` that XLA's CPU backend lowers (Giles' polynomial over a
Cephes ``log1p``/``log``, with the fused multiply-adds XLA emits). The
values equal JAX's on its CPU backend bit for bit, so the port rebuilds the
hash table and the encoders' random init without JAX.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32."""
    return 0, int(seed)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for 0 <= data < 2**32: threefry of
    the key over the seed words ``(0, data)`` of ``data``."""
    if not 0 <= data < 1 << 32:
        raise ValueError(f"fold_in data {data} is not a uint32")
    b1, b2 = _threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                           np.array([data], np.uint32))
    return int(b1[0]), int(b2[0])


def split(key: tuple[int, int], num: int) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``."""
    b1, b2 = _threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                           np.arange(num, dtype=np.uint32))
    return [(int(a), int(b)) for a, b in zip(b1, b2)]


def normal_f32(key: tuple[int, int], n: int, start: int = 0) -> np.ndarray:
    """Flat entries ``[start, start + n)`` of ``jax.random.normal(key,
    shape)`` in float32, for any shape of fewer than 2**32 entries."""
    b1, b2 = _threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                           np.arange(start, start + n, dtype=np.uint32))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        return _F32(np.sqrt(2)) * _erf_inv_xla(_uniform_open(b1 ^ b2))


def normal(key: tuple[int, int], shape, block: int = 1 << 20) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32, made in blocks of
    ``block`` entries so the temporaries stay small. Blocks are independent
    and numpy releases the interpreter lock in them, so several threads
    (up to 8) make them at once."""
    n = int(np.prod(shape))
    out = np.empty(n, np.float32)

    def fill(a: int) -> None:
        b = min(n, a + block)
        out[a:b] = normal_f32(key, b - a, a)

    starts = range(0, n, block)
    workers = min(len(starts), os.cpu_count() or 1, 8)
    if workers <= 1:
        for a in starts:
            fill(a)
    else:
        with ThreadPoolExecutor(workers) as pool:
            for _ in pool.map(fill, starts):
                pass
    return out.reshape(shape)
