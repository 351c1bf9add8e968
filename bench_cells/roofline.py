"""The chip's published peaks and the work the benchmark counts for each
kernel and model: operations and bytes computed from the inputs the
benchmark made, never from the program's counters, so that a change to the
program cannot move the yardstick. Each input byte is counted read once and
each output byte written once, for valid rows and keys only."""

from __future__ import annotations

import numpy as np

from .families import family

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str = "bf16") -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def matmul_params(dims: dict) -> int:
    """Weights of the encoder's matrix products, all layers (the family
    module's ``matmul_params``)."""
    return family(dims["family"]).matmul_params(dims)


def weight_bytes(dims: dict) -> int:
    """bf16 bytes of every weight the forward reads: the matrix products,
    and the rows of the embedding tables."""
    return 2 * matmul_params(dims)


def window_pairs(lengths, window: int) -> np.ndarray:
    """Query-key pairs a layer's attention scores in each text of
    ``lengths`` real tokens: all L^2 of them in a full layer (``window``
    0), those with |i - j| <= window // 2 in a windowed one."""
    n = np.asarray(lengths, np.float64)
    if not window:
        return n * n
    r = np.minimum(window // 2, np.maximum(n - 1, 0))
    return n * (2 * r + 1) - r * (r + 1)


def _attention_pairs(dims: dict, lengths, windowed: bool | None) -> tuple[int, float]:
    """(layers, query-key pairs summed over them) of the layers chosen by
    ``windowed``: every layer (None), the full ones (False) or the windowed
    ones (True), each over its own window."""
    windows = [w for w in family(dims["family"]).layer_windows(dims)
               if windowed is None or bool(w) == windowed]
    return len(windows), float(sum(window_pairs(lengths, w).sum() for w in windows))


def encoder_flops(dims: dict, lengths) -> float:
    """Model operations of the encoder over texts of ``lengths`` real
    tokens: 2 per matrix-product weight a token, and the attention's two
    products over the valid keys inside each layer's window (4 x hidden a
    query-key pair)."""
    n = np.asarray(lengths, np.float64)
    _layers, pairs = _attention_pairs(dims, lengths, None)
    return float(2.0 * matmul_params(dims) * n.sum() + 4.0 * dims["hidden"] * pairs)


def attention_work(dims: dict, lengths, windowed: bool | None = None) -> tuple[float, float]:
    """(bytes, operations) of the attention over the layers ``windowed``
    chooses (every layer for None, the full layers for False, the windowed
    ones for True) for texts of ``lengths`` real tokens: q read and o
    written, K and V read (bf16) for the valid keys, the f32 mask read;
    QK^T and PV over the valid keys inside the layer's window of each valid
    query row."""
    n = np.asarray(lengths, np.float64)
    layers, pairs = _attention_pairs(dims, lengths, windowed)
    nbytes = layers * (4 * 2 * dims["hidden"] * n.sum() + 4 * n.sum())
    return float(nbytes), 4.0 * dims["hidden"] * pairs


def score_pass_work(rows: int, d: int, queries: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one exact cosine top-k over ``rows`` bf16 rows
    of width ``d``: the rows and their validity read once, f32 queries read,
    k (score, index) pairs written; 2 x rows x d operations a query."""
    nbytes = rows * d * 2 + rows + queries * d * 4 + queries * k * 8
    return float(nbytes), float(2.0 * rows * d * queries)


POSTING_BYTES = 8   # a posting: its document (int32) and its weight (f32)
