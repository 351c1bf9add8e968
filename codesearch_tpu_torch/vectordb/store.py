"""Device-resident vector store on torch (device half of
``codesearch_tpu/vectordb/store.py``).

The JAX store's host persistence (generation files, op log, sidecars, the
small-corpus host path) is reused unchanged by subclassing. What changes is
the device state: the corpus is one preallocated ``[capacity, d]`` tensor
(bf16, or int8 with per-row scales) plus a validity mask on ``device``,
updated in place, and searched through the port's kernels. There is no
device mesh: the port runs on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from codesearch_tpu.vectordb.store import UPLOAD_BLOCK, SearchResult
from codesearch_tpu.vectordb.store import VectorStore as _HostVectorStore

from ..ops.query_pipeline import (
    hash_embed_hybrid_search,
    hash_embed_hybrid_search_int8,
    hash_embed_search,
    hash_embed_search_int8,
)
from ..ops.topk import cosine_topk, cosine_topk_int8
from ..utils.device import resolve_device, to_host
from . import device_ops

_NOT_PORTED = "BERT-family and batched (wave) search paths are not ported yet (ROADMAP.md Queue 1)"


class VectorStore(_HostVectorStore):
    """Single-device store; ``device`` as for ``resolve_device``."""

    def __init__(self, db_path, dims: int, readonly: bool = False,
                 int8: bool = False, device=None):
        self.device = resolve_device(device)
        super().__init__(db_path, dims, readonly=readonly, int8=int8)

    # ---- placement ---------------------------------------------------------

    def _mesh(self):
        return None

    def _place(self, host_arr: np.ndarray, dtype, row_sharded: bool = True):
        return torch.from_numpy(np.ascontiguousarray(host_arr)).to(
            device=self.device, dtype=dtype)

    def _zeros(self, shape, dtype, row_sharded: bool = True):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _upload_full(self):
        """Full upload at padded capacity, streamed in UPLOAD_BLOCK-row slabs
        so host memory stays bounded by one slab."""
        n = self._rows
        cap = self._device_cap(n)
        valid_all = self._used_valid()
        vmask = self._zeros((cap,), torch.bool)
        if self.int8:
            mat = self._zeros((cap, self.dims), torch.int8)
            scale = self._zeros((cap,), torch.float32)
            for b in range(0, n, UPLOAD_BLOCK):
                hi = min(b + UPLOAD_BLOCK, n)
                mat, scale, vmask = device_ops.insert_rows_int8(
                    mat, scale, vmask, self._read_rows_io(b, hi), valid_all[b:hi], b)
            self._device = ("int8", mat, scale, vmask)
        else:
            mat = self._zeros((cap, self.dims), torch.bfloat16)
            for b in range(0, n, UPLOAD_BLOCK):
                hi = min(b + UPLOAD_BLOCK, n)
                mat, vmask = device_ops.insert_rows(
                    mat, vmask, self._read_rows_io(b, hi), valid_all[b:hi], b)
            self._device = ("bf16", mat, None, vmask)
        self._dev_rows = n
        self._dev_pending_del = []
        self.full_uploads += 1
        return self._device

    def _ensure_device(self):
        """Sync device state with the host: appended rows are written in
        place, deletes clear validity bits; a full upload happens only when
        capacity overflows or after compaction."""
        with self._lock:
            if self._device is None:
                return self._upload_full()
            kind, mat, scale, valid = self._device
            cap = mat.shape[0]
            new = self._rows - self._dev_rows
            if new and self._dev_rows + new > cap:
                return self._upload_full()
            if new:
                valid_all = self._used_valid()
                for b in range(self._dev_rows, self._rows, UPLOAD_BLOCK):
                    hi = min(b + UPLOAD_BLOCK, self._rows)
                    rows, vr = self._rows_range(b, hi), valid_all[b:hi]
                    if kind == "int8":
                        mat, scale, valid = device_ops.insert_rows_int8(
                            mat, scale, valid, rows, vr, b)
                    else:
                        mat, valid = device_ops.insert_rows(mat, valid, rows, vr, b)
                self._dev_rows = self._rows
                self.incremental_updates += 1
            if self._dev_pending_del:
                valid = device_ops.invalidate_rows(valid, self._dev_pending_del, cap)
                self.incremental_updates += 1
                self._dev_pending_del = []
            self._device = (kind, mat, scale, valid)
            return self._device

    # ---- results -------------------------------------------------------------

    def rows_to_ids(self, vals, idx) -> tuple[np.ndarray, np.ndarray]:
        """(scores, row indices) -> (chunk ids [V, k] int64 with -1 for dead
        or padding rows, scores [V, k] f32)."""
        vals, idx = to_host(vals, idx)
        with self._lock:
            id_map = self._cids.view()
            n = len(id_map)
            if n == 0:
                return np.full(idx.shape, -1, np.int64), vals
            cids = id_map[np.clip(idx, 0, n - 1)]
        bad = (idx >= n) | (idx < 0) | (vals < -1e29)
        return np.where(bad, -1, cids), vals

    def _materialize(self, vals, idx) -> list[list[SearchResult]]:
        vals, idx = to_host(vals, idx)
        out: list[list[SearchResult]] = []
        with self._lock:
            cids = self._cids.view()
            valid = self._valid.view()
            for qi in range(vals.shape[0]):
                results: list[SearchResult] = []
                for score, row in zip(vals[qi], idx[qi]):
                    if score < -1e29 or row >= len(cids) or not valid[row]:
                        continue
                    meta = self._fetch_meta(int(row))
                    if meta is not None:
                        results.append(SearchResult(
                            chunk_id=int(cids[row]), score=float(score), metadata=meta))
                out.append(results)
        return out

    def _empty(self, nq: int, raw: bool):
        if raw:
            return np.zeros((nq, 0), np.int64), np.zeros((nq, 0), np.float32)
        return [[] for _ in range(nq)]

    def _dev_tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ---- searches ------------------------------------------------------------

    def search_batch(self, query_vecs: np.ndarray, limit: int) -> list[list[SearchResult]]:
        """Exact multi-query search of embedded query vectors."""
        if query_vecs.ndim == 1:
            query_vecs = query_vecs[None, :]
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                return self._empty(query_vecs.shape[0], raw=False)
            dev = self._ensure_device()
            k = min(limit, max(1, n_valid))
            q = self._dev_tensor(query_vecs.astype(np.float32))
            if dev[0] == "int8":
                vals, idx = cosine_topk_int8(q, dev[1], dev[2], dev[3], k)
            else:
                vals, idx = cosine_topk(q, dev[1], dev[3], k)
        return self._materialize(vals, idx)

    def search_featurized(self, table, ids: np.ndarray, weights: np.ndarray,
                          limit: int, raw: bool = False):
        """Featurized hash-model queries -> embed + exact top-k in one call."""
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                return self._empty(ids.shape[0], raw)
            dev = self._ensure_device()
            k = min(limit, max(1, n_valid))
            ids_t, w_t = self._dev_tensor(ids), self._dev_tensor(weights)
            if dev[0] == "int8":
                vals, idx = hash_embed_search_int8(table, ids_t, w_t, dev[1], dev[2], dev[3], k)
            else:
                vals, idx = hash_embed_search(table, ids_t, w_t, dev[1], dev[3], k)
        if raw:
            return self.rows_to_ids(vals, idx)
        return self._materialize(vals, idx)

    def hybrid_search_featurized(self, table, ids: np.ndarray, weights: np.ndarray,
                                 limit: int, bm_args, raw: bool = False,
                                 defer: bool = False):
        """The hybrid read plane: variant embedding + exact vector top-k +
        resident BM25 top-k in one call. ``bm_args`` comes from the port's
        ``FtsStore.device_query_args``. With ``defer`` the four result
        tensors stay on the device for the caller to read back together."""
        fts_dev, cs, cl, ci, kid, kb, kbpre, imax, b_pw, b_planes = bm_args
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                if defer:
                    nq = ids.shape[0]
                    return (np.zeros((nq, 0), np.float32), np.zeros((nq, 0), np.int32),
                            np.zeros(0, np.float32), np.zeros(0, np.int32))
                return self._empty(ids.shape[0], raw), None, None
            dev = self._ensure_device()
            kv = min(limit, max(1, n_valid))
            ids_t, w_t = self._dev_tensor(ids), self._dev_tensor(weights)
            bm = (fts_dev[0], fts_dev[1], fts_dev[2], self._dev_tensor(cs),
                  self._dev_tensor(cl), self._dev_tensor(ci), int(kid), kb, kbpre, imax)
            dense = {}
            if b_planes is not None:
                dense = {"pw": self._dev_tensor(b_pw), "planes": b_planes}
            if dev[0] == "int8":
                out = hash_embed_hybrid_search_int8(
                    table, ids_t, w_t, dev[1], dev[2], dev[3], kv, *bm, **dense)
            else:
                out = hash_embed_hybrid_search(
                    table, ids_t, w_t, dev[1], dev[3], kv, *bm, **dense)
        if defer:
            return out
        vv, vi, bv, bi = to_host(*out)
        if raw:
            return self.rows_to_ids(vv, vi), bv, bi
        return self._materialize(vv, vi), bv, bi

    def hybrid_search_featurized_many(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    def hybrid_search_encoded_many(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    def search_encoded(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    def hybrid_search_encoded(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)
