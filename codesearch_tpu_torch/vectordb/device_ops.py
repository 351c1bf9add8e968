"""In-place updates of the device corpus (port of
``codesearch_tpu/vectordb/device_ops.py``).

The corpus is a preallocated ``[capacity, d]`` tensor plus a ``[capacity]``
validity mask. Where the JAX package wrote a padded block into a donated
buffer with ``dynamic_update_slice``, the port writes the block's rows in
place (the padding it wrote was the buffer's fill value anyway). Each
function returns the updated tensors so callers keep the JAX call shape.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_fits(arr: torch.Tensor, base: int, n: int) -> None:
    if base < 0 or base + n > arr.shape[0]:
        raise ValueError(
            f"block [{base}, {base + n}) exceeds capacity {arr.shape[0]}")


def insert_rows(mat, valid, rows_f32: np.ndarray, valid_rows: np.ndarray, base: int):
    """Write ``rows_f32`` (rounded to the corpus dtype) and their validity
    bits at row ``base``."""
    n = rows_f32.shape[0]
    _check_fits(mat, base, n)
    block = torch.from_numpy(np.ascontiguousarray(rows_f32, np.float32)).to(mat.dtype)
    mat[base:base + n] = block.to(mat.device)
    valid[base:base + n] = torch.from_numpy(np.asarray(valid_rows, bool)).to(valid.device)
    return mat, valid


def quantize_rows_int8_host(rows_f32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization on the host, in float32."""
    absmax = np.abs(rows_f32).max(axis=1)
    s = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(rows_f32 / s[:, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def insert_rows_int8(mat, scale, valid, rows_f32: np.ndarray,
                     valid_rows: np.ndarray, base: int):
    """int8 variant: quantizes on the host and writes rows, scales and
    validity bits."""
    n = rows_f32.shape[0]
    _check_fits(mat, base, n)
    q, s = quantize_rows_int8_host(np.ascontiguousarray(rows_f32, np.float32))
    mat[base:base + n] = torch.from_numpy(q).to(mat.device)
    scale[base:base + n] = torch.from_numpy(s).to(scale.device)
    valid[base:base + n] = torch.from_numpy(np.asarray(valid_rows, bool)).to(valid.device)
    return mat, scale, valid


def update_1d(arr, host_block: np.ndarray, base: int):
    """Write a host block into a 1-D device tensor at ``base`` (the free
    capacity past it already holds the fill value). Raises when the block
    would pass the end (the caller must rebuild instead)."""
    n = len(host_block)
    _check_fits(arr, base, n)
    arr[base:base + n] = torch.from_numpy(np.ascontiguousarray(host_block)).to(
        device=arr.device, dtype=arr.dtype)
    return arr


def _in_range(row_indices, capacity: int, device) -> torch.Tensor:
    idx = torch.as_tensor(list(row_indices), dtype=torch.long)
    return idx[(idx >= 0) & (idx < capacity)].to(device)


def invalidate_rows(valid, row_indices: list[int], capacity: int):
    """Tombstone rows (indices at or past ``capacity`` are dropped)."""
    valid[_in_range(row_indices, capacity, valid.device)] = False
    return valid


def scatter_fill(arr, row_indices: list[int], capacity: int, fill):
    """Write a constant into rows (indices at or past ``capacity`` are
    dropped)."""
    arr[_in_range(row_indices, capacity, arr.device)] = fill
    return arr
