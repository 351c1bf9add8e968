"""Multi-device sharded vector search over a VectorStore's corpus (port of
``codesearch_tpu/parallel/sharded_store.py``).

Wraps a host-side VectorStore snapshot with mesh-sharded placement: the row
dimension splits over the "data" axis (rows padded with valid=False to
``SHARD_ALIGN`` rows a shard, which keeps each shard's views 16-byte
aligned for the kernels), and queries answer through the exact sharded
top-k. The store itself shards its own corpus when the product runs on a
mesh (``VectorStore._mesh``); this is the read-only wrapper of a snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from ..vectordb.store import SHARD_ALIGN, SearchResult, VectorStore
from .mesh import make_mesh
from .sharded_search import shard_corpus, sharded_cosine_topk


class ShardedSearcher:
    """Read-side accelerator over a VectorStore snapshot on a mesh (default:
    every CUDA device)."""

    def __init__(self, store: VectorStore, mesh=None):
        self.store = store
        self.mesh = mesh or make_mesh()
        with store._lock:
            rows = store._rows_range(0, store._rows)
            valid = store._used_valid().copy()
        n = rows.shape[0]
        self._n_rows = n
        self.corpus = self.valid = None
        if n == 0:
            return
        pad = (-n) % (self.mesh.shape["data"] * SHARD_ALIGN)
        if pad:
            rows = np.concatenate([rows, np.zeros((pad, store.dims), np.float32)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        self.corpus, self.valid = shard_corpus(
            torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(valid), self.mesh)

    def search_batch(self, query_vecs: np.ndarray, limit: int) -> list[list[SearchResult]]:
        if query_vecs.ndim == 1:
            query_vecs = query_vecs[None, :]
        if self._n_rows == 0:
            return [[] for _ in range(query_vecs.shape[0])]
        k = min(limit, self._n_rows)
        q = torch.from_numpy(np.ascontiguousarray(query_vecs, np.float32)).to(self.mesh.lead)
        vals, idx = sharded_cosine_topk(q, self.corpus, self.valid, k)
        return self.store._materialize(vals, idx)
