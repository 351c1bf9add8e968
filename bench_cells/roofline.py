"""The chip's published peaks and the work the benchmark counts for each
kernel and model: operations and bytes computed from the inputs the
benchmark made, never from the program's counters, so that a change to the
program cannot move the yardstick. Each input byte is counted read once and
each output byte written once, for valid rows and keys only."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str = "bf16") -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def matmul_params(dims: dict) -> int:
    """Weights of the encoder's matrix products, all layers."""
    h, i = dims["hidden"], dims["intermediate"]
    if dims["family"] == "nomic":        # fused QKV, output, fc11 + fc12, fc2
        per_layer = 3 * h * h + h * h + 2 * h * i + i * h
    else:                                # Q, K, V, output, MLP in and out
        per_layer = 4 * h * h + 2 * h * i
    return per_layer * dims["layers"]


def weight_bytes(dims: dict) -> int:
    """bf16 bytes of every weight the forward reads: the matrix products,
    and the rows of the embedding tables."""
    return 2 * matmul_params(dims)


def encoder_flops(dims: dict, lengths) -> float:
    """Model operations of the encoder over texts of ``lengths`` real
    tokens: 2 per matrix-product weight a token, and the attention's two
    products over the valid keys (4 x L^2 x hidden a layer)."""
    n = np.asarray(lengths, np.float64)
    return float(2.0 * matmul_params(dims) * n.sum()
                 + 4.0 * dims["layers"] * dims["hidden"] * (n * n).sum())


def attention_work(dims: dict, lengths) -> tuple[float, float]:
    """(bytes, operations) of the attention kernel over every layer for
    texts of ``lengths`` real tokens: q read and o written, K and V read
    (bf16) for the valid keys, the f32 mask read; QK^T and PV over the valid
    keys of each valid query row."""
    n = np.asarray(lengths, np.float64)
    h, layers = dims["hidden"], dims["layers"]
    nbytes = layers * (4 * 2 * h * n.sum() + 4 * n.sum())
    ops = layers * 4.0 * h * (n * n).sum()
    return float(nbytes), float(ops)


def score_pass_work(rows: int, d: int, queries: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one exact cosine top-k over ``rows`` bf16 rows
    of width ``d``: the rows and their validity read once, f32 queries read,
    k (score, index) pairs written; 2 x rows x d operations a query."""
    nbytes = rows * d * 2 + rows + queries * d * 4 + queries * k * 8
    return float(nbytes), float(2.0 * rows * d * queries)


POSTING_BYTES = 8   # a posting: its document (int32) and its weight (f32)
