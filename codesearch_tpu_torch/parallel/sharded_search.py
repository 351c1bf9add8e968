"""Corpus-sharded exact top-k search over a device mesh (port of
``codesearch_tpu/parallel/sharded_search.py``).

The [N, d] corpus splits its rows over the mesh's "data" axis
(``ShardedTensor``): shard ``i`` holds rows ``[i * R, (i + 1) * R)`` on
``mesh.shard_devices[i]``. A query batch is embedded once, on the lead
device, and copied once to each distinct device; each shard takes its
exact local top-``min(k, R)`` with kernel a or b (the plain versions on
the CPU); the candidates move to the lead device, shard-major with each
index offset to the global row, and one exact select merges them. This is
exact: every global top-k member is in its shard's local top-k. Equal
scores keep the lowest position, and shard-major order makes that the
lowest global index, as ``jax.lax.top_k`` gives in the JAX merge.

The merge selects with ``fused_scores_topk`` (kernel c on CUDA) under a
zero ``slot_meta``, ``boost_kid = -1`` and ``DEAD_SLOT``, which leave every
score as it is: ``torch.topk`` promises no tie order. BM25 runs once, on
the lead device, where the FTS keeps its resident arrays.

``ops.topk.cosine_topk`` and ``cosine_topk_int8`` take this path when the
corpus is a ``ShardedTensor`` (the mesh travels with it), so the store's
query entry runs unchanged on a mesh; ``sharded_cosine_topk[_int8]`` are
those two under the JAX package's names.
"""

from __future__ import annotations

import torch

from ..ops import fused_topk
from ..ops import topk
from ..ops.bm25 import DEAD_SLOT


class ShardedTensor:
    """The rows of one logical tensor split over a mesh's "data" axis.
    Consecutive shards on one device are views of one block tensor, so a
    mesh of one repeated device holds a single tensor; writes of a row
    range are split at block edges. ``device`` is the mesh's lead device."""

    def __init__(self, blocks: list[tuple[int, torch.Tensor]], mesh):
        self.blocks = blocks            # (first global row, block tensor)
        self.mesh = mesh
        n = sum(b.shape[0] for _, b in blocks)
        self.shape = (n, *blocks[0][1].shape[1:])
        self.shard_rows = n // mesh.shape["data"]
        r = self.shard_rows
        self.shards = [blk[j * r:(j + 1) * r]
                       for _, blk in blocks for j in range(blk.shape[0] // r)]

    @staticmethod
    def _runs(mesh, n: int) -> list[tuple[torch.device, int, int]]:
        """(device, first row, rows) of each run of consecutive shards that
        share a device."""
        s = mesh.shape["data"]
        if n % s:
            raise ValueError(f"{n} rows do not split evenly over {s} shards "
                             "(pad with valid=False rows)")
        r, runs = n // s, []
        for i, dev in enumerate(mesh.shard_devices):
            if runs and runs[-1][0] == dev:
                runs[-1][2] += r
            else:
                runs.append([dev, i * r, r])
        return [tuple(x) for x in runs]

    @classmethod
    def zeros(cls, shape, dtype, mesh) -> "ShardedTensor":
        return cls([(a, torch.zeros((n, *shape[1:]), dtype=dtype, device=dev))
                    for dev, a, n in cls._runs(mesh, shape[0])], mesh)

    @classmethod
    def place(cls, t: torch.Tensor, mesh) -> "ShardedTensor":
        """Split ``t`` by rows; a block already on its device is a view of
        ``t``, not a copy."""
        return cls([(a, t[a:a + n].to(dev)) for dev, a, n in cls._runs(mesh, t.shape[0])],
                   mesh)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][1].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    def __setitem__(self, key, value) -> None:
        """``t[a:b] = rows`` (a row range, split at block edges) or
        ``t[index] = value`` (a tensor of row indices, each sent to its
        block); ``value`` is a tensor of the written rows or a scalar."""
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            if step != 1:
                raise ValueError("a sharded write takes a contiguous row range")
            for b0, blk in self.blocks:
                lo, hi = max(start, b0), min(stop, b0 + blk.shape[0])
                if lo < hi:
                    part = value[lo - start:hi - start].to(blk.device) \
                        if isinstance(value, torch.Tensor) else value
                    blk[lo - b0:hi - b0] = part
            return
        key = torch.as_tensor(key)
        for b0, blk in self.blocks:
            m = (key >= b0) & (key < b0 + blk.shape[0])
            part = value[m].to(blk.device) if isinstance(value, torch.Tensor) else value
            blk[(key[m] - b0).to(blk.device)] = part


def shard_corpus(corpus: torch.Tensor, valid: torch.Tensor, mesh):
    """Place [N, d] corpus + [N] valid mask sharded over the data axis.
    N must be a multiple of the data-axis size (pad with valid=False rows)."""
    return ShardedTensor.place(corpus, mesh), ShardedTensor.place(valid, mesh)


def _gather_merge(vals: list, idx: list, k: int, shard_rows: int, lead: torch.device):
    """Merge the shards' [Q, kk] candidates on ``lead``: shard-major, each
    shard's indices offset by ``i * shard_rows``, then one exact top-k with
    ties to the lowest position (so the lowest global index)."""
    cat_vals = torch.cat([v.to(lead) for v in vals], dim=1)
    cat_idx = torch.cat([ix.to(lead) + i * shard_rows for i, ix in enumerate(idx)], dim=1)
    take = min(k, cat_vals.shape[1])
    meta = torch.zeros(cat_vals.shape[1], dtype=torch.int32, device=lead)
    kid = torch.full((cat_vals.shape[0],), -1, dtype=torch.int32, device=lead)
    mvals, mpos = fused_topk.fused_scores_topk(cat_vals, meta, kid, take, DEAD_SLOT)
    return mvals, torch.gather(cat_idx, 1, mpos.long())


def sharded_topk(local, queries: torch.Tensor, k: int, *rows: ShardedTensor):
    """The one sharded top-k over ``rows``' mesh: ``local(q, *shard_rows,
    kk)`` (kernel a or b) on every shard with ``kk = min(k, R)``, the
    queries copied once to each distinct device, then ``_gather_merge``."""
    mesh, r = rows[0].mesh, rows[0].shard_rows
    kk = min(k, r)
    q_on = {dev: queries.to(dev) for dev in mesh.distinct}
    outs = [local(q_on[dev], *(t.shards[i] for t in rows), kk)
            for i, dev in enumerate(mesh.shard_devices)]
    return _gather_merge([o[0] for o in outs], [o[1] for o in outs], k, r, mesh.lead)


# the JAX package's names: the one-device top-k, which shards through
# ``ops.topk`` when given ShardedTensors (``shard_corpus``)
sharded_cosine_topk = topk.cosine_topk
sharded_cosine_topk_int8 = topk.cosine_topk_int8
