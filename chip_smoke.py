#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codesearch_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
device and the package beside this file, and exits non-zero otherwise or
when any phase fails:

1. environment: torch/CUDA versions, the card's name and power limit,
   whether msgpack and the native host tier load;
2. builds the kernels from ``codesearch_tpu_torch/csrc`` with nvcc (one
   compiler per source, in parallel);
3. holds each kernel against its plain PyTorch version at the main path's
   shapes, with CUDA-event medians of both (plain-kernel-kernel-plain):
   top-k kernels a, b (the tensor-core score pass, then the radix select)
   at Q in {1, 9, 17} query variants (17: past one 16-query group),
   N=262,144 rows, d=384, k in {10, 200, 500, 4096, 8192}, with exact ties
   and invalid rows, b bit for bit; a's and b's times at Q in {1, 9}, k=200,
   with each one's bound, the device time of each of their kernels (the
   profiler) and the score pass's registers, spills and CTAs an SM (ptxas,
   the occupancy API); kernel c (the radix select) at B in {1, 8} score
   rows and k in {10, 256, 500, 1024, 4096, 8192, 20000}, bit for bit, on
   rows a third exactly 0.0, with exact ties and dead slots; k above the
   rows raising and launching nothing; c's and ``torch.topk``'s device time
   (a replayed CUDA graph) beside the events; attention
   kernels d and e in bf16 at bge-small's heads (H=12, Dh=32) with B=256 and
   S in {64, 256, 512} for d and e, Dh=64 at S=512, e at S in {1024, 2048}
   (ragged, full and holed masks), Dh=64 at S=1024 and B=2, S=16,384 (one row
   full, one fully masked), ragged
   S, the d/e route at its threshold, the encoder's layout (strided views of
   one fused QKV projection) at S in {64, 512}, with padded masks, masks with
   holes (zeros before a row's last valid key) and a fully masked row, d
   timed on ragged and on full masks; the windowed kernel (ModernBERT's
   local layers: window 128 at H=16, Dh=64, B=64, S in {128, 256, 512}, and
   narrower windows, holes, full masks, strided views, S of 1,000 and
   4,096) against its plain twin on every row and ``reference_attention``
   on the valid ones, timed against the composed route and d; a window
   under autograd and bias2d (ALiBi) taking the composed route, counted
   apart and launching no kernel, equal to the CPU's
   ``reference_attention``;
   unsupported inputs raising; the autograd route (inputs that require
   grad: d or e forward, ``reference_attention`` recomputed backward) at the
   training shapes (d at B=64, H=12, S=128 and B=96, H=6, S=256; e at B=8,
   S=2048) against ``reference_attention`` under autograd: the output
   within the kernels' bound, dq, dk, dv within 2e-2 + 2e-2 |ref|, one
   launch a forward and one counted recompute a backward, with the times
   of the forward, the recompute, the route and
   ``scaled_dot_product_attention`` forward and backward;
4. indexes the port's own ``codesearch_tpu_torch/`` sources with the port
   (code-hash-384) and searches that index through the port's CLI
   (``--json``);
5. builds a 262,144-chunk synthetic index through the port's write plane
   (code-hash-384, bf16), answers hybrid, vector-only and identifier
   queries through a port ``SearchSession`` on the GPU, checks the answers
   against the same session on the CPU (plain versions), one of them at
   ``--limit 500``, counts kernel launches, then repeats a short pass on the
   int8 corpus;
6. phase 4 with bge-small (12-layer BERT, random init made from seed 0),
   logging the attention launches by sequence length;
7. phase 5 with bge-small: the synthetic index, hybrid, vector-only and
   identifier queries, a direct call of the encoder attention at S=2048
   (kernel e's branch), launch counts of each of those paths on its own
   (d at least 12 layers for every index batch and for every distinct
   query) with no plain version called on the card, the device's idle
   share, the GPU session held against a CPU
   session (query embeddings agree, each vector list is an exact top-k of
   its own query vector), and a short int8 pass;
8. kernel f (head-packed attention) against its plain twin at the head-
   packing ablation's full width (B=256, H=12, S=512, Dh=32) and at S=64,
   for P=4 and P=2, with ragged masks and a fully masked row, timed on
   ragged and on full masks, on masks with holes, at ragged S, on the
   encoder's strided views and at its sequence bound, with refused
   inputs raising; then the ablation entry point
   (``codesearch_tpu_torch.examples.ablate_head_packing``) at its defaults,
   its launches of f counted on their own, and its table logged;
9. serving on the card, over phase 5's and phase 7's indexes: a wave of 64
   hybrid queries (several hundred variant rows) through ``search_many``
   against the same 64 ``search`` calls (the same hits; kernel a launched
   once, c on the dense leg; a subset held to the CPU session), with wall
   times (medians of 3), device time, idle share and peak memory; a wave of
   16 on the int8 corpus (b once) and of 16 bge-small queries (one encoder
   forward: d once a layer; each vector list an exact top-k of the wave's own
   query vectors);
   the MCP server (``serve_stdio``: initialize, tools/list, a pipelined group
   of 8 ``semantic_search`` calls in one wave, find_references,
   index_status) and the HTTP server (``make_server`` on port 0: 16
   concurrent hybrid POSTs in fewer waves than requests, a ``queries[]``
   body of 64, a ``mode=vector`` request), their answers held to
   ``ranked_chunks``;
10. the rest of the encoder family and neural reranking: kernel d timed at
   nomic-v1.5's and ModernBERT's index batches (Dh=64); nomic-v1.5 as
   registered (12 layers, 768, 12 heads of 64, random init from seed 0)
   indexing 65,536 synthetic chunks and answering hybrid, vector and
   identifier queries, held to a CPU session as phase 7 holds bge-small (d
   at least once a layer of every batch and query); modernbert-large at
   full width with its depth cut to 6 layers (global layers 0 and 3), a
   forward of 256 chunks against the CPU's (d exactly twice and the
   windowed kernel four times a forward), an 8,192-chunk index and hybrid
   queries; ``search --rerank`` (8 queries, the default 100
   candidates) on phase 5's index through a GPU and a CPU session with the
   weights-free proxy, a cross-encoder checkpoint with absolute positions
   (d six times a query) and an ALiBi one (the biased route six times, no
   d), written by the script from seed 0. ``reference_attention`` may run
   on the card only as the biased route, as often as that route counts;
11. training on the card: ``codesearch-torch train`` (in this process) on
   phase 4's index, 3 epochs, against ``--platform cpu`` on a copy (losses
   within 1e-3, the trained tables' bf16 entries equal in 99% of the
   touched rows, the searches after the re-index ranked as a CPU session's
   on the same index, kernels a and c launched); ``train --cross-encoder``
   (one epoch; d once a layer a step and its backward recomputed as
   often), then ``search --rerank`` running the trained
   ``local-cross-encoder`` (d in the pair forwards, ranked as a CPU
   session); bge-small contrastive steps at batch 64 and
   ``max_len`` 128, one held to the CPU's (loss within 1e-2, gradients at
   cosine 0.99 per parameter), ten timed (d 24 times a step and 24
   recomputes, no other plain version), two profiled. The autograd
   route's backward runs ``reference_attention`` as often as it counts.
   After ``train`` the index holds as many chunks as before, and no search
   returns a chunk twice;
12. the rest of the CLI on the card (in this process): ``stats --json``
   over phase 4's indexes (the trained hash index, bge-small's, an int8
   copy) equal to ``--platform cpu``'s; ``doctor --json`` (every check ok,
   equal to the CPU's) and ``doctor --device --json`` (the probe's round
   trip on the card, named) on an index of a copy of the port's sources;
   ``search --all-repos --json`` over two registered copies (bf16 and int8)
   from a directory that holds neither, every group equal to that
   repository's own ``search``, kernels a, b and c launched under the path
   ``all_repos`` (no plain version called), each of their calls held
   against its plain version on the same inputs, and the groups ranked as
   the CPU's off near-ties;
13. the corpus mesh on the card (``codesearch_tpu_torch.parallel``), four
   logical shards of the one card installed as the corpus mesh and the
   cache restored after: ``sharded_cosine_topk`` and ``_int8`` at N=1,048,576,
   d=384, k=200, Q in {1, 9} over 2, 4 and 8 shards against the one-device
   kernel (indices equal, b bit for bit, a within SCORE_TOL; a tie across a
   shard edge ranked lowest index first), timed beside it; phase 5's and
   phase 7's indexes (bf16 and int8) through sharded sessions (hybrid,
   vector, identifier queries and a 64-query ``search_many`` wave), ranked
   as one-device sessions with scores bit for bit; ``dp_embed_features``
   over the port's sources' chunks (1e-5), ``dp_encode`` of bge-small on 256
   chunks at bucket 512 (d 12 x 4 times) against one-device ``encode``, and
   an ``index`` of the port's sources on the mesh (phase 4's chunk count and
   hits). Its launches are the path "sharded" of a, b, c and d, with no
   plain version and no ``torch.topk`` called; the merge's c launches are
   counted apart from the BM25 legs', and every a, b and c call of the
   phase (each shard's, the one-device call's and each merge's) is held
   against its plain version on its own inputs;
14. the training mesh (``codesearch_tpu_torch.parallel.train_mesh``,
   ``parallel.launch``): bge-small as registered, phase 11c's ten timed
   batches (64 at ``max_len`` 128), first through the one-device
   ``make_train_step`` (the reference), then (a) a 1 x 1 mesh over NCCL in
   this process, its losses and parameters bit for bit the reference's, and
   (b) a 2 x 2 mesh of four spawned ranks on the one card over gloo: rank
   0's first loss within 1e-2 of the reference's and every loss within
   5e-2, each of the first step's gathered gradients at cosine 0.99, its
   norm within 3e-2 and its relative L2 error within 0.15 of the
   reference's, the gathered parameters within 2 x steps x lr and each
   parameter's update within 0.5 relative L2 error (a witness, the
   reference's steps with d's plain version forward, is logged beside:
   how far a last-bit difference carries); on every rank kernel d 24 times
   a step on its 6 local
   heads, as many recomputes, no other plain version, its first d call
   equal to its plain version, nothing of the JAX side imported. d's
   launches of (a) and (b) are the path "train_mesh", and d is timed at the
   local-head shape (B=32, H=6, S=128, Dh=32).

15. the checkpoints of the benchmark's index cells (nomic-v1.5,
   modernbert-large: seeded fp16 ``model.safetensors``) read by
   ``read_safetensors`` onto the card through its pinned ring and onto the
   CPU: every tensor byte-equal; the ring's read timed against a plain one
   (the whole data section into one pageable host tensor, one copy); the
   encoder ``load_safetensors`` builds on the card equal, buffer for
   buffer, to the one built from the host path it replaced (numpy, f32,
   transposed on the host, uploaded from pageable memory); each path's
   seconds, bytes/s and device peak logged, in turns (after phase 10 in the
   full run).

Beside each kernel's time (CUDA events around one call) it prints its
bound on the card (the larger of the bytes it must move over 3.35 TB/s and
its operations over the peak rate of their type), for every kernel and the
library calls of c-f also the device time a call from a replayed CUDA graph
(events around one call also count the host's time to launch it),
and, where one PyTorch call computes
the same function, that call's time (``library_ms``:
``scaled_dot_product_attention`` for d, e, f; ``torch.topk`` over the
pre-boosted rows for c; none for a and b). It
prints one JSON line of per-kernel results, the ``nvidia-smi`` name and
power-limit line, and last the result line the harness reads. It fails if
``jax`` or any module of the JAX package ``codesearch_tpu`` was imported.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS = 262_144
DIMS = 384
N_QUERIES = 9
SCORE_TOL = 1e-5    # bf16 kernel vs plain: f32 sums over d=384 in another order
# d and e against their plain twins, both rounding a bf16 output: f32 sums in
# another order (and e's near-f32 p) move an output across a bf16 rounding
# boundary at most, one bf16 ulp (2**-7 relative) of the value
ATTN_ATOL = 1e-2
ATTN_RTOL = 1e-2
# kernel f must keep its own rounding (p normalised in f32, then cast to
# bf16): one bf16 step passes d's order too (bf16(p) @ V, then the divide),
# so f may also differ from its twin in at most this share of outputs (sums
# in another order flip a rounding now and then), and d's order, run on the
# same inputs, must exceed it (it rounds every p otherwise)
PACKED_SHARE_MAX = 0.02
BERT_MODEL = "bge-small"
BERT_LAYERS = 12
BERT_BATCH = 256        # bge-small's device batch when indexing (embed/service.py)
EMBED_COS_MIN = 0.999   # GPU against CPU query embeddings (bf16 activations)
WAVE_COS_MIN = 1 - 1e-5  # a wave's query embeddings against per-query ones, same device
_TOPK_CU = "codesearch_tpu_torch/csrc/topk_kernels.cu"
_ATTN_CU = "codesearch_tpu_torch/csrc/attention_kernels.cu"
SOURCES = {
    "fused_cosine_topk": _TOPK_CU,
    "fused_cosine_topk_int8": _TOPK_CU,
    "fused_scores_topk": _TOPK_CU,
    "attention_full": _ATTN_CU,
    "attention_flash": _ATTN_CU,
    "attention_packed": _ATTN_CU,
    "attention_window": _ATTN_CU,
}
REPLACES = {
    "fused_cosine_topk": "codesearch_tpu/ops/pallas_topk.py:244",
    "fused_cosine_topk_int8": "codesearch_tpu/ops/pallas_topk.py:201",
    "fused_scores_topk": "codesearch_tpu/ops/pallas_topk.py:164",
    "attention_full": "codesearch_tpu/ops/attention.py:110",
    "attention_flash": "codesearch_tpu/ops/attention.py:140",
    "attention_packed": "examples/ablate_head_packing.py:88",
    # no Pallas kernel: the XLA composition reference_attention(window=w)
    "attention_window": "codesearch_tpu/ops/attention.py:24",
}
# the kernels' plain versions: none may run on the card's main path (the
# head-packing ablation computes reference_attention as its reference row;
# phase 10's ALiBi layers run it as their composed route)
PLAIN_VERSIONS = {
    "codesearch_tpu_torch.ops.fused_topk": (
        "fused_cosine_topk_plain", "fused_cosine_topk_int8_plain", "fused_scores_topk_plain"),
    "codesearch_tpu_torch.ops.attention": (
        "attention_full_plain", "attention_flash_plain", "attention_window_plain",
        "reference_attention"),
    "codesearch_tpu_torch.ops.packed_attention": ("attention_packed_plain",),
}
# published H100 SXM peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
VERBS = ["parse", "walk", "render", "compute", "merge", "flush", "encode",
         "resolve", "validate", "dispatch", "batch", "cache", "track", "scan", "load"]
NOUNS = ["config", "tree", "buffer", "index", "token", "matrix", "query", "chunk",
         "socket", "widget", "metric", "schema", "branch", "vector", "posting"]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.ops import packed_attention as pa

    ft.reset_launch_counts()
    att.reset_launch_counts()
    pa.reset_launch_counts()


def launch_counts() -> dict:
    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.ops import packed_attention as pa

    return {**ft.launch_counts, **att.launch_counts, **pa.launch_counts}


def route_counts() -> dict:
    """``launch_counts()`` and the composed attention route's calls
    (``composed_window``, ``composed_bias2d``) and the autograd route's
    backward recomputes (``composed_backward``)."""
    from codesearch_tpu_torch.ops import attention as att

    return {**launch_counts(), **{f"composed_{k}": v for k, v in att.composed_counts.items()}}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes moved (each input read once,
    each output written once) over the memory rate against operations over
    the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_bound(q, mask) -> dict:
    """What the function needs on these inputs: q read and o written in
    full (bf16) and the f32 mask read once; K and V read, and QK^T and PV
    computed (Dh multiply-adds each per query row and key), only for the keys
    that count: a row's valid keys, or all S of a fully masked row (its
    output is the mean of V). A masked key beside a valid one adds exact 0."""
    b, h, s, dh = q.shape
    lens = mask.sum(dim=1)
    keys = float((lens + (lens == 0) * s).sum())    # summed over the batch
    return bound(2 * b * h * s * dh * 2 + 2 * h * keys * dh * 2 + b * s * 4,
                 4 * h * s * keys * dh, "bf16")


def sdpa_call(q, k, v, mask):
    """One scaled_dot_product_attention call with the same additive mask as
    the attention kernels (timed here only; the port never calls it)."""
    import torch.nn.functional as F

    bias = ((1.0 - mask.float()) * -1e30)[:, None, None, :].to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def sdpa_ms(q, k, v, mask) -> float:
    """``library_ms`` of an attention kernel: the median time of one
    ``sdpa_call`` (CUDA events)."""
    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms

    return cuda_ms(sdpa_call(q, k, v, mask), reps=10)


def device_ms(fn, calls: int = 10):
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed between two CUDA events, so the host's time to launch
    them is not counted (it dominates CUDA-event times of one call for
    kernels of tens of microseconds); None if ``fn`` cannot be captured."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as e:
        log(f"  device time not measured: the CUDA graph capture failed ({e})")
        return None
    graph.replay()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


class PlainCalls:
    """Counts calls of the kernels' plain versions while active (each
    wrapper looks its plain version up by module-global name)."""

    def __enter__(self):
        self.calls: collections.Counter = collections.Counter()
        self._saved = []
        for modname, names in PLAIN_VERSIONS.items():
            mod = importlib.import_module(modname)
            for name in names:
                fn = getattr(mod, name)
                self._saved.append((mod, name, fn))

                def counted(*args, _fn=fn, _name=name, **kwargs):
                    self.calls[_name] += 1
                    return _fn(*args, **kwargs)

                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_corpus(n: int, d: int, gen):
    """Unit rows with every 7th row a copy of its neighbour (exact ties)
    and ~5% invalid rows."""
    import torch

    c = torch.randn(n, d, generator=gen)
    c = c / c.norm(dim=1, keepdim=True)
    dup = c[0::7][: c[1::7].shape[0]]
    c[1::7] = dup
    valid = torch.rand(n, generator=gen) > 0.05
    return c, valid


def compare_cosine(got, ref, ref_next, plain_scores):
    """bf16 -> (max |score - plain| by position, max |score - plain score
    of the row it names|, index mismatches away from near-ties). Indices
    must be equal wherever the plain scores around a position are apart by
    more than SCORE_TOL (``ref_next`` is the plain top-(k+1), which shows
    ties across the k-th position); ``plain_scores`` [Q, N] are the plain
    version's masked scores of every row."""
    gv, gi = got
    rv, ri = ref
    err = float((gv - rv).abs().max())
    row_err = float((gv - plain_scores.gather(1, gi.long())).abs().max())
    nv = ref_next[0]
    gap = (nv[:, :-1] - nv[:, 1:]).abs() > SCORE_TOL          # [Q, k]
    clear = gap.clone()
    clear[:, 1:] &= gap[:, :-1]
    bad = (gi != ri) & clear
    for qi, pos in bad.nonzero().tolist()[:5]:
        lo, hi = max(pos - 2, 0), pos + 3
        log(f"  mismatch q={qi} pos={pos}: kernel {gi[qi, lo:hi].tolist()} "
            f"{gv[qi, lo:hi].tolist()}, plain {ri[qi, lo:hi].tolist()} {rv[qi, lo:hi].tolist()}")
    return err, row_err, int(bad.sum())


def kernel_checks(device: str) -> dict:
    import torch

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.examples.topk_variants import kernel_split, score_pass_resources
    from codesearch_tpu_torch.ops import _build
    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.ops.bm25 import DEAD_SLOT
    from codesearch_tpu_torch.ops.topk import quantize_rows_int8

    gen = torch.Generator().manual_seed(0)
    c, valid = make_corpus(N_ROWS, DIMS, gen)
    q17 = (c[:17] + 0.02 * torch.randn(17, DIMS, generator=gen)).to(device)
    q9 = q17[:N_QUERIES]
    cb = c.to(torch.bfloat16).to(device)
    vd = valid.to(device)
    cq, scale = quantize_rows_int8(c)
    cq, scale = cq.to(device), scale.to(device)
    results = {}
    # a multi-word query has one variant, an identifier up to nine; 17 runs
    # two 16-query groups of the score pass; every k goes through the radix
    # select (sorting its winners up to 16,384)
    cases = [(q, k) for q in (q17[:1], q9, q17) for k in (10, 200, 500, 4096, 8192)]
    for q, k in cases:
        nq = q.shape[0]
        got = ft.fused_cosine_topk(q, cb, vd, k)
        torch.cuda.synchronize()
        ref = ft.fused_cosine_topk_plain(q, cb, vd, k)
        plain_scores = torch.where(vd[None, :], q.to(torch.bfloat16).float() @ cb.float().T,
                                   ft.NEG_INF)
        err, row_err, mism = compare_cosine(
            got, ref, ft.fused_cosine_topk_plain(q, cb, vd, k + 1), plain_scores)
        log(f"kernel a fused_cosine_topk Q={nq} N={N_ROWS} k={k}: "
            f"max |score - plain| {err}, max |score - plain score of its row| {row_err} "
            f"(tol {SCORE_TOL}), index mismatches away from near-ties {mism}")
        check(err <= SCORE_TOL and row_err <= SCORE_TOL and mism == 0,
              f"fused_cosine_topk disagrees at Q={nq} k={k}")
        results.setdefault("fused_cosine_topk", {})[(nq, k)] = err

        got = ft.fused_cosine_topk_int8(q, cq, scale, vd, k)
        torch.cuda.synchronize()
        ref = ft.fused_cosine_topk_int8_plain(q, cq, scale, vd, k)
        same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        log(f"kernel b fused_cosine_topk_int8 Q={nq} N={N_ROWS} k={k}: "
            f"values and indices equal: {same}")
        check(same, f"fused_cosine_topk_int8 disagrees at Q={nq} k={k}")
        results.setdefault("fused_cosine_topk_int8", {})[(nq, k)] = float(
            (got[0] - ref[0]).abs().max())
        del plain_scores

    meta = torch.randint(0, 6, (N_ROWS,), generator=gen, dtype=torch.int32)
    meta[torch.rand(N_ROWS, generator=gen) < 0.05] = DEAD_SLOT
    md = meta.to(device)
    for b in (1, 8):
        s = torch.rand(b, N_ROWS, generator=gen)
        s[:, ::3] = 0.0                                   # docs without a dense term
        s[:, 1::5] = s[:, 0::5][:, : s[:, 1::5].shape[1]]  # exact ties
        kid = torch.arange(b, dtype=torch.int32) % 7 - 1  # -1: no boost
        sd, kd = s.to(device), kid.to(device)
        for k in (10, 256, 500, 1024, 4096, 8192, 20000):
            got = ft.fused_scores_topk(sd, md, kd, k, DEAD_SLOT)
            torch.cuda.synchronize()
            ref = ft.fused_scores_topk_plain(sd, md, kd, k, DEAD_SLOT)
            same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            log(f"kernel c fused_scores_topk B={b} N={N_ROWS} k={k}: values and "
                f"indices equal: {same}")
            check(same, f"fused_scores_topk disagrees at B={b} k={k}")
            results.setdefault("fused_scores_topk", {})[(b, k)] = float(
                (got[0] - ref[0]).abs().max())

    # k above the selectable rows raises and launches nothing; no other k
    # is refused (the loops above reach k=8192 and 20000)
    before = dict(ft.launch_counts)
    for name, call in (
            ("fused_cosine_topk", lambda: ft.fused_cosine_topk(q9, cb, vd, N_ROWS + 1)),
            ("fused_cosine_topk_int8",
             lambda: ft.fused_cosine_topk_int8(q9, cq, scale, vd, N_ROWS + 1)),
            ("fused_scores_topk",
             lambda: ft.fused_scores_topk(sd, md, kd, N_ROWS + 1, DEAD_SLOT))):
        try:
            call()
        except ValueError as e:
            log(f"{name} k={N_ROWS + 1} > n raises: {e}")
        else:
            raise SmokeFailure(f"{name} accepted k={N_ROWS + 1} above its {N_ROWS} rows")
    check(ft.launch_counts == before, "a wrapper launched for k above its rows")

    # times at the main path's shapes: a hybrid query's fetch=200 vector
    # top-k over its variants (1 for a multi-word query, up to 9), and the
    # dense BM25 leg's kp=256 selection over one score row. The first shape
    # of each kernel is the one reported in the JSON line, Q=9 beside it.
    # Bounds: each counting only the rows this run's data needs (valid
    # corpus rows, live score slots) besides every row's flag; a and b read
    # the f32 queries and write Q x k results (the corpus read dominates at
    # both Q); no one PyTorch call computes a or b (a masked cosine matmul
    # plus a top-k with the lowest index on ties)
    s1 = torch.rand(1, N_ROWS, generator=gen).to(device)
    k1 = torch.tensor([2], dtype=torch.int32, device=device)
    n_valid, n_live = int(vd.sum()), int((md != DEAD_SLOT).sum())
    timed = {"fused_cosine_topk": [], "fused_cosine_topk_int8": [], "fused_scores_topk": []}
    for q in (q17[:1], q9):
        nq = q.shape[0]
        io = N_ROWS + nq * DIMS * 4 + nq * 200 * 8
        timed["fused_cosine_topk"].append((
            nq, f"Q={nq} k=200", lambda q=q: ft.fused_cosine_topk(q, cb, vd, 200),
            lambda q=q: ft.fused_cosine_topk_plain(q, cb, vd, 200),
            bound(n_valid * DIMS * 2 + io, 2 * nq * n_valid * DIMS, "bf16")))
        timed["fused_cosine_topk_int8"].append((
            nq, f"Q={nq} k=200", lambda q=q: ft.fused_cosine_topk_int8(q, cq, scale, vd, 200),
            lambda q=q: ft.fused_cosine_topk_int8_plain(q, cq, scale, vd, 200),
            bound(n_valid * (DIMS + 4) + io, 2 * nq * n_valid * DIMS, "int8")))
    timed["fused_scores_topk"].append((
        1, "B=1 k=256", lambda: ft.fused_scores_topk(s1, md, k1, 256, DEAD_SLOT),
        lambda: ft.fused_scores_topk_plain(s1, md, k1, 256, DEAD_SLOT),
        bound(n_live * 4 + N_ROWS * 4 + 4 + 256 * 8, n_live, "f32")))
    # the score pass's registers and spills (ptxas, from the build log) and
    # CTAs an SM at d=DIMS (the occupancy API)
    ptxas = score_pass_resources(_build.build_log["output"])
    build = {name: {**ptxas.get(kind, {"regs": "not in the build log (a cached build)"}),
                    "ctas_per_sm": _build.load().cs_cosine_ctas_per_sm(int(kind == "b"), DIMS)}
             for name, kind in (("fused_cosine_topk", "a"), ("fused_cosine_topk_int8", "b"))}
    out = {}
    for name, shapes in timed.items():
        for nq, shape, kern, plain, bnd in shapes:
            t_plain_1 = cuda_ms(plain)
            t_kern_1 = cuda_ms(kern)
            t_kern_2 = cuda_ms(kern)
            t_plain_2 = cuda_ms(plain)
            row = {"ms": min(t_kern_1, t_kern_2), "plain_ms": min(t_plain_1, t_plain_2),
                   "device_ms": device_ms(kern), **bnd}
            split = kernel_split(kern)
            log(f"time {name} {shape} N={N_ROWS}: kernel {t_kern_1}/{t_kern_2} ms, plain "
                f"{t_plain_1}/{t_plain_2} ms (median of 20, plain-kernel-kernel-plain); device "
                f"ms a call (CUDA graph of 10 calls): kernel {row['device_ms']}; bound "
                f"{row['bound_ms']} ms ({row['bound_by']}), device share of the bound "
                f"{row['bound_ms'] / row['device_ms']:.3f}; device us a call by kernel "
                f"(profiler): {json.dumps(split)}")
            if name not in out:
                out[name] = {"max_abs_err": max(results[name].values()), **row}
            else:   # a's and b's Q=9 row beside the reported Q=1 one
                out[name].update({f"q{nq}_{key}": v for key, v in row.items()})
    for name in ("fused_cosine_topk", "fused_cosine_topk_int8"):
        out[name].update(library_ms=None, score_pass=build[name])
        log(f"score pass of {name}: {build[name]}")
    boosted = torch.where(md[None, :] == DEAD_SLOT, ft.NEG_INF,
                          s1 * torch.where(md[None, :] == k1[:, None], 3.0, 1.0))
    topk_call = lambda: torch.topk(boosted, 256, dim=1)  # noqa: E731
    out["fused_scores_topk"].update(library_ms=cuda_ms(topk_call),
                                    library_device_ms=device_ms(topk_call))
    for name, v in out.items():
        log(f"bound {name}: {v['bound_ms']} ms ({v['bound_by']}); kernel {v['ms']} ms "
            f"(device {v['device_ms']}); library call {v['library_ms']} ms"
            + (f" (device {v['library_device_ms']})" if "library_device_ms" in v else ""))

    # c beyond the main path's k
    for k in (4096, 20000):
        kern = lambda k=k: ft.fused_scores_topk(s1, md, k1, k, DEAD_SLOT)  # noqa: E731
        log(f"time fused_scores_topk B=1 k={k}: kernel {cuda_ms(kern)} ms, device {device_ms(kern)} "
            f"ms; torch.topk {cuda_ms(lambda k=k: torch.topk(boosted, k, dim=1))} ms")
    return out


def attention_inputs(b: int, h: int, s: int, dh: int, seed: int, device: str,
                     fused_qkv: bool = False, masks: str = "ragged"):
    """bf16 [B, H, S, Dh] q, k, v (normal) and a [B, S] padding mask.
    ``masks``: "ragged", random lengths with row 0 full and the last row
    fully masked; "holes", the same with about a quarter of the keys before
    each row's last valid one zeroed too; "full", every key valid.
    ``fused_qkv`` makes q, k and v the encoder's strided views of one
    [B, S, 3 * H * Dh] projection instead of contiguous tensors."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    if fused_qkv:
        qkv = torch.randn(b, s, 3 * h * dh, generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (t.view(b, s, h, dh).transpose(1, 2) for t in qkv.split(h * dh, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, s, dh, generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(3))
    cpu = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, s + 1, (b,), generator=cpu)
    lengths[0], lengths[-1] = s, 0
    if masks == "full":
        lengths[:] = s
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.float32)
    if masks == "holes":
        last = (lengths - 1).clamp(min=0)[:, None]
        hole = (torch.rand(b, s, generator=cpu) < 0.25) & (torch.arange(s)[None, :] < last)
        mask[hole] = 0.0
    return q, k, v, mask.to(device)


def compare_attention(got, ref) -> tuple[float, float, bool]:
    """(max |kernel - plain|, share of outputs that differ, within
    ATTN_ATOL + ATTN_RTOL * |plain| everywhere)."""
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()).all())
    return float(diff.max()), float((diff > 0).float().mean()), ok


def attention_checks(device: str) -> dict:
    """Kernels d and e against their plain twins (bf16) and their times."""
    import torch

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.ops import attention as att

    bound = {dh: att.full_max_seq(dh) for dh in att.HEAD_DIMS}
    log(f"the d/e route's threshold (full_max_seq): {bound}")
    # the route on the card: d up to the threshold, e one key beyond
    for dh, s in bound.items():
        for s_route, name in ((s, "attention_full"), (s + 1, "attention_flash")):
            q, k, v, mask = attention_inputs(1, 2, s_route, dh, seed=s_route, device=device)
            before = dict(att.launch_counts)
            att.fused_encoder_attention(q, k, v, mask)
            check(att.launch_counts[name] == before[name] + 1,
                  f"fused_encoder_attention at S={s_route} Dh={dh} did not launch {name}")
    # (name, B, H, S, Dh, timed, fused_qkv, masks): bge-small's buckets at its
    # batch of 256, bge-base/large's head size at S=512, e at d's bge-small
    # shapes and at S=2048 (ragged, full, holes), Dh=64 and one long S whose
    # bias streams through 256 tiles, ragged S, each threshold, the encoder's
    # layout (q, k, v views of one fused projection) at bge-small's shortest
    # and longest bucket, then d on full masks (what skipping padding keys
    # gains) and on masks with holes
    cases = [("attention_full", 256, 12, 64, 32, True, False, "ragged"),
             ("attention_full", 256, 12, 256, 32, True, False, "ragged"),
             ("attention_full", 256, 12, 512, 32, True, False, "ragged"),
             ("attention_full", 128, 12, 512, 64, True, False, "ragged"),
             ("attention_full", 4, 12, 100, 32, False, False, "ragged"),
             ("attention_full", 2, 12, bound[32], 32, False, False, "ragged"),
             ("attention_full", 2, 12, bound[64], 64, False, False, "ragged"),
             ("attention_full", 256, 12, 64, 32, False, True, "ragged"),
             ("attention_full", 256, 12, 512, 32, False, True, "ragged"),
             ("attention_flash", 256, 12, 64, 32, True, False, "ragged"),
             ("attention_flash", 256, 12, 256, 32, True, False, "ragged"),
             ("attention_flash", 256, 12, 512, 32, True, False, "ragged"),
             ("attention_flash", 32, 12, 1024, 32, True, False, "ragged"),
             ("attention_flash", 8, 12, 2048, 32, True, False, "ragged"),
             ("attention_flash", 8, 12, 2048, 32, True, False, "full"),
             ("attention_flash", 16, 12, 1024, 64, True, False, "ragged"),
             ("attention_flash", 2, 12, 16384, 32, True, False, "ragged"),
             ("attention_flash", 8, 12, 2048, 32, False, False, "holes"),
             ("attention_flash", 4, 12, 1000, 32, False, False, "ragged"),
             ("attention_flash", 256, 12, 512, 32, False, True, "ragged"),
             ("attention_full", 256, 12, 512, 32, True, False, "full"),
             ("attention_full", 256, 12, 64, 32, True, False, "full"),
             ("attention_full", 256, 12, 512, 32, False, False, "holes"),
             ("attention_full", 256, 12, 64, 32, False, False, "holes"),
             ("attention_full", 128, 12, 512, 64, False, False, "holes")]
    kernels = {"attention_full": (att.attention_full, att.attention_full_plain),
               "attention_flash": (att.attention_flash, att.attention_flash_plain)}
    errs: dict = collections.defaultdict(float)
    out: dict = {}
    for i, (name, b, h, s, dh, timed, fused_qkv, masks) in enumerate(cases):
        kern, plain = kernels[name]
        q, k, v, mask = attention_inputs(b, h, s, dh, seed=i, device=device, fused_qkv=fused_qkv,
                                         masks=masks)
        got = kern(q, k, v, mask)
        torch.cuda.synchronize()
        ref = plain(q.contiguous(), k.contiguous(), v.contiguous(), mask)
        err, share, ok = compare_attention(got, ref)
        finite = bool(torch.isfinite(got).all())
        layout = "views of a fused QKV projection" if fused_qkv else "contiguous"
        log(f"kernel {'d' if name == 'attention_full' else 'e'} {name} B={b} H={h} S={s} "
            f"Dh={dh} ({layout}, {masks} masks): max |out - plain| {err} (tol {ATTN_ATOL} + "
            f"{ATTN_RTOL}|plain|), share of outputs differing {share:.2e}, all finite "
            f"{finite}, fully masked row {got[-1, 0, 0, :4].float().tolist()}")
        check(ok and finite, f"{name} disagrees with its plain version at B={b} S={s} "
              f"Dh={dh} ({layout}, {masks} masks)")
        errs[name] = max(errs[name], err)
        if timed:
            t_plain_1 = cuda_ms(lambda: plain(q, k, v, mask), reps=10)
            t_kern_1 = cuda_ms(lambda: kern(q, k, v, mask), reps=10)
            t_kern_2 = cuda_ms(lambda: kern(q, k, v, mask), reps=10)
            t_plain_2 = cuda_ms(lambda: plain(q, k, v, mask), reps=10)
            row = {"ms": min(t_kern_1, t_kern_2), "plain_ms": min(t_plain_1, t_plain_2),
                   **attention_bound(q, mask), "library_ms": sdpa_ms(q, k, v, mask),
                   "device_ms": device_ms(lambda: kern(q, k, v, mask)),
                   "library_device_ms": device_ms(sdpa_call(q, k, v, mask))}
            log(f"time {name} B={b} H={h} S={s} Dh={dh} ({masks} masks): kernel {t_kern_1}/"
                f"{t_kern_2} ms, plain {t_plain_1}/{t_plain_2} ms (median of 10, plain-kernel-"
                f"kernel-plain); scaled_dot_product_attention {row['library_ms']} ms; bound "
                f"{row['bound_ms']} ms ({row['bound_by']}); device ms a call (CUDA graph of "
                f"10 calls): kernel {row['device_ms']}, scaled_dot_product_attention "
                f"{row['library_device_ms']}")
            # the JSON line reports d at bge-small's largest bucket, e at S=2048
            if (name, s, dh, masks) in (("attention_full", 512, 32, "ragged"),
                                        ("attention_flash", 2048, 32, "ragged")):
                out[name] = row
        del q, k, v, mask, got, ref
        torch.cuda.empty_cache()

    out["attention_window"] = window_checks(device)
    composed_checks(device)
    # what the kernels do not take raises on the card and launches nothing
    q, k, v, mask = attention_inputs(2, 12, 64, 32, seed=99, device=device)
    z48 = torch.zeros(2, 12, 64, 48, dtype=torch.bfloat16, device=device)
    before = dict(att.launch_counts)
    for what, call, exc in (
            ("requires_grad (kernel d's wrapper alone)", lambda: att.attention_full(
                q.clone().requires_grad_(True), k, v, mask), NotImplementedError),
            ("f32 inputs", lambda: att.attention_full(q.float(), k.float(), v.float(), mask),
             TypeError),
            ("Dh=48", lambda: att.attention_flash(z48, z48, z48, mask), ValueError)):
        try:
            call()
        except exc as e:
            log(f"attention with {what} on the card raises {type(e).__name__}: {e}")
        else:
            raise SmokeFailure(f"attention with {what} on the card did not raise")
    check(att.launch_counts == before, "an attention wrapper launched on refused inputs")
    for name in out:
        out[name]["max_abs_err"] = errs[name]
    return out


# (kernel, B, H, S, Dh, shape): the training shapes of phase 11 (bge-small's
# contrastive batch, the cross-encoder's largest pair batch) and e past d's
# threshold
GRAD_CASES = [("attention_full", 64, 12, 128, 32, "contrastive (bge-small, B=64, S=128)"),
              ("attention_full", 96, 6, 256, 32, "cross-encoder pairs (B=96, S=256)"),
              ("attention_flash", 8, 12, 2048, 32, "e at S=2048")]
GRAD_ATOL = 2e-2    # dq, dk, dv against reference_attention's autograd
GRAD_RTOL = 2e-2


def attention_backward_bound(q, mask) -> dict:
    """The least time of the backward on these inputs: q, k, v and the
    output gradient read and dq, dk, dv written (bf16; K and V only over
    the keys that count, as ``attention_bound``), and five products (the
    scores again, dV, dP, dQ, dK: 2 Dh operations each per query row and key)."""
    b, h, s, dh = q.shape
    lens = mask.sum(dim=1)
    keys = float((lens + (lens == 0) * s).sum())
    return bound(4 * b * h * s * dh * 2 + 4 * h * keys * dh * 2 + b * s * 4,
                 10 * h * s * keys * dh, "bf16")


def attention_grad_checks(device: str) -> dict:
    """The autograd route of ``fused_encoder_attention`` (kernel d or e
    forward, ``reference_attention`` recomputed backward) against
    ``reference_attention`` differentiated by autograd on the same bf16
    inputs: the output within ATTN_ATOL + ATTN_RTOL |ref|, dq, dk, dv within
    GRAD_ATOL + GRAD_RTOL |ref|, the kernel launched once a forward and the
    recompute counted once a backward. Times (CUDA events): the kernel's
    forward (and its device time), its plain twin's, the recompute
    backward, the route's forward and backward, and
    ``scaled_dot_product_attention`` forward, and forward and backward."""
    import torch
    import torch.nn.functional as F

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.ops import attention as att

    out = {}
    for i, (name, b, h, s, dh, shape) in enumerate(GRAD_CASES):
        q, k, v, mask = attention_inputs(b, h, s, dh, seed=200 + i, device=device)
        g = torch.randn(q.shape, generator=torch.Generator(device=device).manual_seed(i),
                        device=device).to(torch.bfloat16)
        leaves, ref_leaves = ([t.clone().requires_grad_(True) for t in (q, k, v)]
                              for _ in range(2))
        launches, recomputes = att.launch_counts[name], att.composed_counts["backward"]
        got = att.fused_encoder_attention(*leaves, mask)
        check(att.launch_counts[name] == launches + 1,
              f"the autograd route at {shape} did not launch {name} once")
        got.backward(g)
        check(att.composed_counts["backward"] == recomputes + 1,
              f"the autograd route's backward at {shape} was not counted once")
        ref = att.reference_attention(*ref_leaves, mask)
        ref.backward(g)
        torch.cuda.synchronize()
        err, _, ok = compare_attention(got.detach(), ref.detach())
        grad_err, grad_ok = {}, True
        for gname, a, w in zip(("dq", "dk", "dv"), leaves, ref_leaves):
            diff = (a.grad.float() - w.grad.float()).abs()
            grad_err[gname] = float(diff.max())
            grad_ok &= bool((diff <= GRAD_ATOL + GRAD_RTOL * w.grad.float().abs()).all()
                            and torch.isfinite(a.grad).all())
        log(f"autograd route {name} {shape}: max |out - reference| {err} (tol {ATTN_ATOL} + "
            f"{ATTN_RTOL}|ref|), max |grad - reference's| {grad_err} (tol {GRAD_ATOL} + "
            f"{GRAD_RTOL}|ref|)")
        check(ok and grad_ok, f"the autograd route disagrees with reference_attention at {shape}")
        kern = getattr(att, name)
        fwd = lambda: kern(q, k, v, mask)  # noqa: E731

        def recompute():
            with torch.enable_grad():
                torch.autograd.grad(att.reference_attention(*leaves, mask), leaves, g)

        def route():
            torch.autograd.grad(att.fused_encoder_attention(*leaves, mask), leaves, g)

        bias = ((1.0 - mask.float()) * -1e30)[:, None, None, :].to(torch.bfloat16)

        def sdpa():
            torch.autograd.grad(F.scaled_dot_product_attention(*leaves, attn_mask=bias),
                                leaves, g)

        plain = getattr(att, name + "_plain")
        row = {"shape": shape, "forward_ms": cuda_ms(fwd, reps=10),
               "forward_device_ms": device_ms(fwd),
               "plain_forward_ms": cuda_ms(lambda: plain(q, k, v, mask), reps=10),
               "sdpa_forward_ms": sdpa_ms(q, k, v, mask),
               "backward_recompute_ms": cuda_ms(recompute, reps=10),
               "route_forward_backward_ms": cuda_ms(route, reps=10),
               "sdpa_forward_backward_ms": cuda_ms(sdpa, reps=10),
               **attention_bound(q, mask),
               "backward_bound_ms": attention_backward_bound(q, mask)["bound_ms"],
               "max_abs_err": err, "max_grad_err": max(grad_err.values())}
        log(f"time autograd route {name} {shape}: {json.dumps(row)}")
        out.setdefault(name, []).append(row)
        del q, k, v, mask, g, leaves, ref_leaves, got, ref
        torch.cuda.empty_cache()
    return out


def window_bound(q, mask, window: int) -> dict:
    """``attention_bound`` over a band: q read and o written in full, K and
    V read once for the keys that count, the f32 mask read; QK^T and PV
    only for each valid query row's valid keys with |i - j| <= window // 2."""
    import torch

    b, h, s, dh = q.shape
    lens = mask.sum(dim=1)
    keys = float((lens + (lens == 0) * s).sum())
    i = torch.arange(s, device=mask.device)
    band = ((i[:, None] - i[None, :]).abs() <= window // 2).float()
    pairs = float(torch.einsum("bi,ij,bj->", mask.float(), band, mask.float()))
    return bound(2 * b * h * s * dh * 2 + 2 * h * keys * dh * 2 + b * s * 4,
                 4 * h * pairs * dh, "bf16")


# (B, H, S, Dh, window, timed, fused_qkv, masks): ModernBERT's local layers
# (H=16, Dh=64, window 128) at its index batch of 64 over the buckets 128, 256
# and 512 (timed: the composed route, the kernel and d without a window), the
# encoder's strided views, masks with holes and full masks, bge-small's heads
# at two narrow windows, S past d's bound and a long S (its plain twin alone:
# the reference's scores would not fit beside it)
WINDOW_CASES = [(64, 16, 128, 64, 128, True, False, "ragged"),
                (64, 16, 256, 64, 128, True, False, "ragged"),
                (64, 16, 512, 64, 128, True, False, "ragged"),
                (64, 16, 512, 64, 128, False, True, "ragged"),
                (64, 16, 512, 64, 128, False, False, "holes"),
                (64, 16, 512, 64, 128, False, False, "full"),
                (256, 12, 512, 32, 16, False, False, "ragged"),
                (32, 12, 200, 32, 8, False, True, "holes"),
                (4, 16, 1000, 64, 128, False, False, "ragged"),
                (2, 16, 4096, 64, 128, False, False, "ragged")]


def window_checks(device: str) -> dict:
    """The windowed kernel against its plain twin on every row and against
    ``reference_attention(window=w)`` on the valid rows (bf16, one launch a
    call, every output finite; the reference up to S=2048), and at
    ModernBERT's local layers (B=64, H=16, Dh=64, window 128) its time
    against the composed route and kernel d without a window (CUDA events,
    plain-kernel-kernel-plain, and device ms of a replayed CUDA graph),
    beside its bound. Returns the row at S=512."""
    import torch

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.ops import attention as att

    out: dict = {}
    for i, (b, h, s, dh, w, timed, fused_qkv, masks) in enumerate(WINDOW_CASES):
        q, k, v, mask = attention_inputs(b, h, s, dh, seed=100 + i, device=device,
                                         fused_qkv=fused_qkv, masks=masks)
        before = att.launch_counts["attention_window"]
        got = att.attention_window(q, k, v, mask, w)
        torch.cuda.synchronize()
        check(att.launch_counts["attention_window"] == before + 1,
              f"attention_window did not launch once at B={b} S={s}")
        twin = att.attention_window_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask, w)
        err, share, ok = compare_attention(got, twin)
        finite = bool(torch.isfinite(got).all())
        ref_err, ref_ok = None, True
        if s <= 2048:
            ref = att.reference_attention(q, k, v, mask, window=w)
            valid = mask.bool()[:, None, :, None].expand_as(got)
            ref_err, _, ref_ok = compare_attention(got[valid], ref[valid])
            del ref
        layout = "views of a fused QKV projection" if fused_qkv else "contiguous"
        log(f"windowed kernel B={b} H={h} S={s} Dh={dh} window={w} ({layout}, {masks} masks): "
            f"max |out - plain| {err}, share differing {share:.2e}; max |out - "
            f"reference_attention| on valid rows {ref_err} (tol {ATTN_ATOL} + {ATTN_RTOL}|ref|); "
            f"all finite {finite}")
        check(ok and ref_ok and finite, f"the windowed kernel disagrees at B={b} S={s} Dh={dh} "
              f"window={w} ({layout}, {masks} masks)")
        if timed:
            def composed():
                return att.reference_attention(q, k, v, mask, window=w)

            def kernel():
                return att.attention_window(q, k, v, mask, w)

            def d():
                return att.attention_full(q, k, v, mask)

            t_c1, t_k1 = cuda_ms(composed, reps=5), cuda_ms(kernel, reps=10)
            t_k2, t_c2 = cuda_ms(kernel, reps=10), cuda_ms(composed, reps=5)
            row = {"ms": min(t_k1, t_k2), "composed_ms": min(t_c1, t_c2),
                   "d_ms": cuda_ms(d, reps=10), **window_bound(q, mask, w),
                   "device_ms": device_ms(kernel), "composed_device_ms": device_ms(composed, 3),
                   "d_device_ms": device_ms(d), "max_abs_err": err}
            log(f"time ModernBERT local layer B={b} H={h} S={s} Dh={dh} window={w} ({masks} "
                f"masks): windowed kernel {t_k1}/{t_k2} ms (device {row['device_ms']}), composed "
                f"route {t_c1}/{t_c2} ms (device {row['composed_device_ms']}), kernel d without "
                f"a window {row['d_ms']} ms (device {row['d_device_ms']}); bound "
                f"{row['bound_ms']} ms ({row['bound_by']})")
            out[s] = row
        del q, k, v, mask, got, twin
        torch.cuda.empty_cache()
    return {**out[512], "by_seq": out}


def composed_checks(device: str) -> None:
    """Biased attention, and windowed attention under autograd, take the
    composed route on the card (``reference_attention``, as JAX composes
    them in XLA on every backend): ModernBERT's window of 128 at its heads
    (H=16, Dh=64, S=512) with q requiring grad and an ALiBi bias at
    bge-small's (H=12, Dh=32, S=256) each count once in ``composed_counts``,
    launch no kernel and equal the CPU's ``reference_attention`` on the same
    inputs within one bf16 step."""
    import torch

    from codesearch_tpu_torch.ops import attention as att

    for what, (b, h, s, dh) in (("window", (4, 16, 512, 64)), ("bias2d", (4, 12, 256, 32))):
        q, k, v, mask = attention_inputs(b, h, s, dh, seed=77, device=device)
        kw = {"window": 128} if what == "window" else {"bias2d": att.alibi_bias(h, s, device)}
        launches, composed = dict(att.launch_counts), dict(att.composed_counts)
        grad_q = q.clone().requires_grad_(what == "window")
        got = att.fused_encoder_attention(grad_q, k, v, mask, **kw).detach()
        torch.cuda.synchronize()
        check(att.launch_counts == launches, f"attention with {what} launched a kernel")
        check(att.composed_counts[what] == composed[what] + 1,
              f"attention with {what} did not count its composed route")
        cpu_kw = {"window": 128} if what == "window" else {"bias2d": kw["bias2d"].cpu()}
        ref = att.reference_attention(q.cpu(), k.cpu(), v.cpu(), mask.cpu(), **cpu_kw)
        err, share, ok = compare_attention(got.cpu(), ref)
        log(f"attention with {what}{' under autograd' if what == 'window' else ''} on the card: "
            f"the composed route, no kernel launched, max |out - CPU reference| {err} (tol "
            f"{ATTN_ATOL} + {ATTN_RTOL}|ref|), share of outputs differing {share:.2e} (B={b} H={h} "
            f"S={s} Dh={dh})")
        check(ok and bool(torch.isfinite(got).all()),
              f"attention with {what} on the card disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# phase 8: kernel f and the head-packing ablation
# ---------------------------------------------------------------------------

def packed_checks(device: str) -> dict:
    """Kernel f against its plain twin (bf16), its times, bound and the
    library call at the ablation's full width, and its refusals."""
    import torch

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.ops import packed_attention as pa

    # (B, H, S, P, timed, fused_qkv, masks): the ablation's width for both P,
    # its shortest bucket, ragged S, the sequence bound and the encoder's
    # views, then the ablation's width on full masks and on masks with holes
    cases = [(256, 12, 512, 4, True, False, "ragged"), (256, 12, 512, 2, True, False, "ragged"),
             (256, 12, 64, 4, True, False, "ragged"), (256, 12, 64, 2, True, False, "ragged"),
             (4, 12, 100, 4, False, False, "ragged"), (4, 8, 1000, 2, False, False, "ragged"),
             (2, 12, pa.PACKED_MAX_SEQ, 4, False, False, "ragged"),
             (256, 12, 512, 4, False, True, "ragged"),
             (256, 12, 512, 4, True, False, "full"), (256, 12, 512, 2, True, False, "full"),
             (256, 12, 512, 4, False, False, "holes"), (256, 12, 512, 2, False, False, "holes")]
    err = 0.0
    out: dict = {}
    for i, (b, h, s, pack, timed, fused_qkv, masks) in enumerate(cases):
        q, k, v, mask = attention_inputs(b, h, s, 32, seed=100 + i, device=device,
                                         fused_qkv=fused_qkv, masks=masks)
        got = pa.attention_packed(q, k, v, mask, pack)
        torch.cuda.synchronize()
        ref = pa.attention_packed_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                                        pack)
        e, share, ok = compare_attention(got, ref)
        d_err, d_share, _ = compare_attention(
            att.attention_full_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask), ref)
        finite = bool(torch.isfinite(got).all())
        layout = "views of a fused QKV projection" if fused_qkv else "contiguous"
        log(f"kernel f attention_packed B={b} H={h} S={s} P={pack} ({layout}, {masks} masks): "
            f"max |out - plain| {e} (tol {ATTN_ATOL} + {ATTN_RTOL}|plain|), share of outputs "
            f"differing {share:.2e} (limit {PACKED_SHARE_MAX}; d's order: max {d_err}, share "
            f"{d_share:.2e}), all finite {finite}, fully masked row "
            f"{got[-1, 0, 0, :4].float().tolist()}")
        check(ok and finite and share <= PACKED_SHARE_MAX,
              f"attention_packed disagrees with its plain version at B={b} "
              f"H={h} S={s} P={pack} ({layout}, {masks} masks)")
        check(d_share > PACKED_SHARE_MAX, f"the share limit does not tell d's rounding from "
              f"f's at B={b} H={h} S={s} P={pack}")
        err = max(err, e)
        if timed:
            t_plain_1 = cuda_ms(lambda: pa.attention_packed_plain(q, k, v, mask, pack), reps=10)
            t_kern_1 = cuda_ms(lambda: pa.attention_packed(q, k, v, mask, pack), reps=10)
            t_kern_2 = cuda_ms(lambda: pa.attention_packed(q, k, v, mask, pack), reps=10)
            t_plain_2 = cuda_ms(lambda: pa.attention_packed_plain(q, k, v, mask, pack), reps=10)
            lib = sdpa_ms(q, k, v, mask)
            bnd = attention_bound(q, mask)
            log(f"time attention_packed B={b} H={h} S={s} P={pack} ({masks} masks): kernel "
                f"{t_kern_1}/{t_kern_2} ms, plain {t_plain_1}/{t_plain_2} ms (median of 10, "
                f"plain-kernel-kernel-plain); scaled_dot_product_attention {lib} ms; bound "
                f"{bnd['bound_ms']} ms ({bnd['bound_by']}); device ms a call (CUDA graph of "
                f"10 calls): kernel {device_ms(lambda: pa.attention_packed(q, k, v, mask, pack))}, "
                f"scaled_dot_product_attention {device_ms(sdpa_call(q, k, v, mask))}")
            # the JSON line reports P=4, the ablation's headline packing
            out.setdefault("attention_packed", {
                "ms": min(t_kern_1, t_kern_2), "plain_ms": min(t_plain_1, t_plain_2),
                **bnd, "library_ms": lib})
        del q, k, v, mask, got, ref
        torch.cuda.empty_cache()

    q, k, v, mask = attention_inputs(2, 12, 64, 32, seed=199, device=device)
    z64 = torch.zeros(2, 12, 64, 64, dtype=torch.bfloat16, device=device)
    before = dict(pa.launch_counts)
    for what, call, exc in (
            ("f32 inputs", lambda: pa.attention_packed(q.float(), k.float(), v.float(), mask),
             TypeError),
            ("pack=3", lambda: pa.attention_packed(q, k, v, mask, 3), ValueError),
            ("H=10, pack=4", lambda: pa.attention_packed(q[:, :10], k[:, :10], v[:, :10], mask),
             ValueError),
            ("Dh=64", lambda: pa.attention_packed(z64, z64, z64, mask), ValueError),
            ("requires_grad", lambda: pa.attention_packed(q.clone().requires_grad_(True), k, v,
                                                          mask), NotImplementedError)):
        try:
            call()
        except exc as e:
            log(f"attention_packed with {what} on the card raises {type(e).__name__}: {e}")
        else:
            raise SmokeFailure(f"attention_packed with {what} on the card did not raise")
    check(pa.launch_counts == before, "attention_packed launched on refused inputs")
    out["attention_packed"]["max_abs_err"] = err
    return out


def packed_ablation(work: Path) -> dict:
    """The head-packing ablation entry point at its defaults (B=256, H=12,
    S=512, Dh=32) on the card, its launches counted on their own. Kernel f
    must launch, no kernel's plain twin may run (the study's reference row is
    reference_attention by design), and f's rows must agree with the
    reference within one bf16 step."""
    from codesearch_tpu_torch.examples import ablate_head_packing as abl

    table = work / "head_packing.md"
    with PlainCalls() as plain:
        reset_counts()
        rc = abl.main(["--device", "cuda", "--out", str(table)])
        counts = launch_counts()
    twins = {n: c for n, c in plain.calls.items() if n != "reference_attention"}
    log(f"head-packing ablation: exit {rc}, kernel launches {counts}, plain versions called "
        f"{dict(plain.calls)}")
    check(rc == 0, f"the ablation exited {rc}")
    check(counts["attention_packed"] > 0 and counts["attention_full"] > 0,
          "the ablation did not launch kernels f and d")
    check(not twins, f"kernel plain twins ran in the ablation: {twins}")
    lines = table.read_text().splitlines()
    rows = lines[lines.index("|---|---|---|") + 1:]
    rows = rows[:next((i for i, line in enumerate(rows) if not line.startswith("|")),
                      len(rows))]
    errs = {line.split("|")[1].strip(): float(line.split("|")[2]) for line in rows}
    log(f"head-packing ablation's verdict: {lines[-1]}")
    check(len(errs) == 4 and all(e <= ATTN_ATOL + ATTN_RTOL for n, e in errs.items()
                                 if n.startswith("kernel f")),
          f"the ablation's kernel f rows disagree with the reference: {errs}")
    return counts


# ---------------------------------------------------------------------------
# phase 4: the port's own sources through index() and the CLI
# ---------------------------------------------------------------------------

SELF_QUERY = "exact cosine top-k over the corpus"


def repo_index_and_cli(work: Path, device: str, model: str = "code-hash-384") -> dict:
    """Index the port's sources and search them through the CLI; returns the
    chunk count and the CLI's (path, start line, score) hits."""
    from codesearch_tpu_torch.index import IndexOptions, index

    db = work / f"self-db-{model}"
    t0 = time.perf_counter()
    stats = index(ROOT / "codesearch_tpu_torch",
                  IndexOptions(store_path=db, quiet=True, model=model), device=device)
    log(f"index codesearch_tpu_torch/ with {model}: {stats.files_indexed} files, "
        f"{stats.chunks_added} chunks in {time.perf_counter() - t0:.2f} s")
    check(stats.chunks_added > 100, "indexing the repository's sources found too few chunks")
    check(json.loads((db / "metadata.json").read_text())["model"] == model,
          f"the index metadata does not name {model}")
    cmd = [sys.executable, "-m", "codesearch_tpu_torch.cli", "--store", str(db),
           *(["--platform", "cpu"] if device == "cpu" else []),
           "search", SELF_QUERY, str(ROOT / "codesearch_tpu_torch"),
           "--json", "--limit", "5"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env=os.environ.copy(), stdin=subprocess.DEVNULL)
    check(proc.returncode == 0, f"CLI search failed ({proc.returncode}): {proc.stderr[-2000:]}")
    resp = json.loads(proc.stdout)
    hits = resp["results"]
    log(f"CLI search --json in {time.perf_counter() - t0:.2f} s: {len(hits)} hits, top "
        f"{hits[0]['path'] if hits else None}")
    check(len(hits) == 5 and all(any((base / h["path"]).is_file()
                                     for base in (ROOT / "codesearch_tpu_torch", ROOT))
                          for h in hits),
          "CLI search returned unexpected results")
    # the hash model ranks by code features; bge-small's random weights rank noise
    check(model != "code-hash-384" or all(h["path"].endswith(".py") for h in hits),
          "CLI search returned unexpected results")
    return {"chunks": stats.chunks_added,
            "hits": [(h["path"], h["start_line"], h["score"]) for h in hits]}


# ---------------------------------------------------------------------------
# phase 5: the synthetic corpus through SearchSession
# ---------------------------------------------------------------------------

HYBRID_QUERIES = ["validate the schema and return it"] + [
    f"{v} the {o} and return it" for v, o in zip(VERBS[:7], NOUNS[3:10])]
VECTOR_QUERIES = ["render widget metric", "merge the branch vector", "scan the socket",
                  "cache token matrix"]
# "shared_registry" alone expands to six query variants
IDENT_QUERIES = ["shared_registry sync", "where is shared_registry used", "shared_registry"]
DEEP_LIMIT = 500        # a --limit the GPU session once refused (above 409 hybrid)


def synthetic_chunks(a: int, b: int) -> list:
    """Chunks ``a`` to ``b`` of bench.py's synthetic corpus, with an
    identifier in every third chunk."""
    from codesearch_tpu_torch.embed import Chunk, ChunkKind

    chunks = []
    for i in range(a, b):
        v, o = VERBS[i % 15], NOUNS[(i // 15) % 15]
        extra = "    shared_registry.sync(arg)\n" if i % 3 == 0 else ""
        body = (f"def {v}_{o}_{i}(arg):\n"
                f'    """{v.capitalize()} the {o} and return the result."""\n'
                f"{extra}    return arg.{o} + {i}\n")
        g = i // 64
        chunks.append(Chunk(content=body, start_line=0, end_line=3,
                            kind=ChunkKind.FUNCTION, path=f"src/{NOUNS[g % 15]}/mod_{g}.py",
                            signature=f"def {v}_{o}_{i}(arg)"))
    return chunks


def build_synthetic(db: Path, n_rows: int, device: str, model: str = "code-hash-384") -> dict:
    """bench.py's synthetic corpus through the port's write plane, with an
    identifier in every third chunk (df ~ n/3: above the 65,536 plane floor
    and below the 0.4 n stopword cap at n = 262,144)."""
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.fts import FtsStore
    from codesearch_tpu_torch.index import IndexStats, write_metadata
    from codesearch_tpu_torch.vectordb import ChunkMetadata, VectorStore

    svc = EmbeddingService(model, use_persistent_cache=False, device=device)
    store = VectorStore(db, dims=svc.dims, device=device)
    fts = FtsStore(db / "fts", device=device)
    ph = {"gen": 0.0, "embed": 0.0, "vstore": 0.0, "fts": 0.0, "commit": 0.0}
    t_all = time.perf_counter()
    for a in range(0, n_rows, 8192):
        t = time.perf_counter()
        chunks = synthetic_chunks(a, min(n_rows, a + 8192))
        ph["gen"] += time.perf_counter() - t
        t = time.perf_counter()
        embs = svc.embed_chunks_matrix(chunks)
        ph["embed"] += time.perf_counter() - t
        t = time.perf_counter()
        metas = [ChunkMetadata(path=c.path, content=c.content, start_line=0, end_line=3,
                               kind=c.kind.value, signature=c.signature, hash=c.hash,
                               language="Python") for c in chunks]
        ids = store.insert_chunks_with_ids(embs, metas)
        ph["vstore"] += time.perf_counter() - t
        t = time.perf_counter()
        fts.add_chunks([(cid, m.content, m.path, m.signature, m.kind)
                        for cid, m in zip(ids, metas)])
        ph["fts"] += time.perf_counter() - t
        if (a + 8192) % 65536 == 0:
            t = time.perf_counter()
            fts.commit()
            ph["commit"] += time.perf_counter() - t
    t = time.perf_counter()
    store.build_index()
    store.save()
    fts.commit()
    ph["commit"] += time.perf_counter() - t
    total = time.perf_counter() - t_all
    write_metadata(db, svc, IndexStats(db_path=db, primary_language="Python"))
    out = {"seconds": total, "chunks_per_s": n_rows / total, "phases_s": ph}
    counts = getattr(svc.backend, "counts", None)
    if counts is not None:   # BERT-family: the encoder's token counts
        out.update(tokens=counts["tokens"], padded_tokens=counts["padded_tokens"],
                   tokens_per_s=counts["tokens"] / total,
                   padded_tokens_per_s=counts["padded_tokens"] / total)
    return out


def set_int8(db: Path, int8: bool) -> None:
    p = db / "metadata.json"
    meta = json.loads(p.read_text())
    meta["int8"] = int8
    p.write_text(json.dumps(meta, indent=2))


def run_queries(session, queries, mode: str):
    """(ms per query, hit chunk ids per query, the session's own per-stage
    timings per query) for uncached queries."""
    import torch

    from codesearch_tpu_torch.search import SearchOptions

    times, hits, stages = [], [], []
    for qtext in queries:
        if session.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        resp = session.search(qtext, SearchOptions(limit=10, mode=mode))
        times.append((time.perf_counter() - t) * 1000)
        check(len(resp.hits) > 0, f"no hits for {qtext!r}")
        check(all(h.score == h.score and abs(h.score) < 1e6 for h in resp.hits),
              f"non-finite scores for {qtext!r}")
        hits.append([h.chunk_id for h in resp.hits])
        stages.append(resp.timings_ms)
    return times, hits, stages


def stage_medians(stages: list[dict]) -> dict:
    keys = [k for k, v in stages[0].items() if isinstance(v, float)]
    return {k: statistics.median(s[k] for s in stages) for k in keys}


def timed_pass(session, queries, mode: str) -> float:
    """Wall ms of one pass over the queries with the response cache cleared."""
    import torch

    session._resp_cache.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run_queries(session, queries, mode)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1000


def device_kernel_time(prof) -> tuple[float, dict]:
    """(device ms of a profiled run, the six longest kernels' ms). Only the
    device's own events count: under kineto a CPU op's row carries the time
    of the kernels it launched too, so summing every row would count that
    time twice (torch's own table sums the device rows alone)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return (sum(e.self_device_time_total for e in events) / 1000,
            {e.key[:60]: e.self_device_time_total / 1000 for e in top})


def device_busy_share(session, queries, mode: str) -> dict:
    """The device's idle share of a pass over uncached queries: device
    kernel time from a profiled pass, against the wall time of an
    unprofiled pass just before it (the profiler slows the host down, so
    its own wall time would overstate the idle share; both are printed)."""
    from torch.profiler import ProfilerActivity, profile

    wall_ms = timed_pass(session, queries, mode)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = timed_pass(session, queries, mode)
    busy_ms, top = device_kernel_time(prof)
    check(busy_ms > 0, "the profiler saw no device time")
    return {"queries": len(queries), "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "top_device_ms": top}


def synthetic_session(work: Path, n_rows: int, device: str, cpu_check: bool) -> dict:
    import torch

    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    db = work / "synthetic-db"
    built = build_synthetic(db, n_rows, device)
    log(f"synthetic index: {n_rows} chunks in {built['seconds']:.2f} s "
        f"({built['chunks_per_s']:.1f} chunks/s), phases {built['phases_s']}")
    out = {"index": built}
    for int8 in (False, True):
        set_int8(db, int8)
        t = time.perf_counter()
        session = SearchSession(db, device=device)
        probe = session.search("validate the schema and return it", SearchOptions(limit=10))
        warm_s = time.perf_counter() - t
        check(any("validate_schema" in (h.signature or "") for h in probe.hits),
              "the top 10 of 'validate the schema and return it' holds no validate_schema chunk")
        kind, mat = session.store._device[0], session.store._device[1]
        check(kind == ("int8" if int8 else "bf16") and mat.device.type == torch.device(device).type,
              f"corpus is {kind} on {mat.device}")
        log(f"session ({'int8' if int8 else 'bf16'}) open + first query {warm_s:.2f} s; "
            f"corpus {kind} {tuple(mat.shape)} on {mat.device}")
        session._resp_cache.clear()
        queries = {"hybrid": HYBRID_QUERIES, "vector": VECTOR_QUERIES, "identifier": IDENT_QUERIES}
        if int8:
            queries = {"hybrid": HYBRID_QUERIES[:4], "vector": VECTOR_QUERIES[:2]}
        ft.reset_launch_counts()
        res = {}
        for qtype, qs in queries.items():
            mode = "vector" if qtype == "vector" else "hybrid"
            res[qtype] = run_queries(session, qs, mode)
        counts = dict(ft.launch_counts)
        n_device_queries = sum(len(set(qs)) for qs in queries.values())
        tag = "int8" if int8 else "bf16"
        for qtype, (times, _hits, stages) in res.items():
            log(f"{tag} {qtype} queries: n={len(times)} p50 {statistics.median(times)} ms "
                f"max {max(times)} ms; session stages p50 ms {stage_medians(stages)}")
        log(f"{tag} kernel launches during the queries: {counts}")
        if device == "cuda" and not int8:
            for qtype in ("hybrid", "vector"):
                mode = "vector" if qtype == "vector" else "hybrid"
                log(f"{tag} {qtype} profiled pass: "
                    f"{json.dumps(device_busy_share(session, queries[qtype], mode))}")
        cos = "fused_cosine_topk_int8" if int8 else "fused_cosine_topk"
        if device == "cuda":
            check(counts[cos] >= n_device_queries, f"{cos} launched {counts[cos]} times "
                  f"for {n_device_queries} queries")
            if not int8:
                check(counts["fused_scores_topk"] >= 1, "fused_scores_topk never launched")
        out[tag] = {"launches": counts,
                    "p50_ms": {t: statistics.median(v[0]) for t, v in res.items()}}
        if cpu_check and not int8:
            cpu = SearchSession(db, device="cpu")
            _, cpu_hits, _ = run_queries(cpu, HYBRID_QUERIES[:3] + IDENT_QUERIES, "hybrid")
            _, cpu_vec, _ = run_queries(cpu, VECTOR_QUERIES[:2], "vector")
            gpu_hits = res["hybrid"][1][:3] + res["identifier"][1] + res["vector"][1][:2]
            overlap = [len(set(a) & set(b)) / max(len(a), 1)
                       for a, b in zip(gpu_hits, cpu_hits + cpu_vec)]
            same = sum(a == b for a, b in zip(gpu_hits, cpu_hits + cpu_vec))
            log(f"GPU vs CPU session top-10 overlap per query: {overlap}; identical "
                f"ranked lists {same}/{len(gpu_hits)}")
            check(same == len(gpu_hits), "GPU and CPU sessions rank different hits")
            # a deep candidate list: --limit 500 (fetch 1500 a leg; the
            # identifier's dense BM25 leg selects with kernel c), held to the
            # CPU session hit for hit
            deep = SearchOptions(limit=DEEP_LIMIT)
            session._resp_cache.clear()
            ft.reset_launch_counts()
            t = time.perf_counter()
            gpu_deep = [h.chunk_id for h in session.search(IDENT_QUERIES[0], deep).hits]
            deep_ms = (time.perf_counter() - t) * 1000
            deep_counts = dict(ft.launch_counts)
            cpu_deep = [h.chunk_id for h in cpu.search(IDENT_QUERIES[0], deep).hits]
            log(f"hybrid --limit {DEEP_LIMIT} {IDENT_QUERIES[0]!r} on the GPU: {len(gpu_deep)} hits "
                f"in {deep_ms:.2f} ms, launches {deep_counts}; the same ranked list as the CPU "
                f"session: {gpu_deep == cpu_deep}")
            check(len(gpu_deep) == DEEP_LIMIT and gpu_deep == cpu_deep,
                  f"the GPU and CPU sessions rank different hits at --limit {DEEP_LIMIT}")
            check(deep_counts["fused_scores_topk"] >= 1 and deep_counts["fused_cosine_topk"] >= 1,
                  f"the --limit {DEEP_LIMIT} query did not launch kernels a and c")
            del cpu
        del session
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: bge-small through the synthetic corpus
# ---------------------------------------------------------------------------

def check_exact_topk(cids, scores, ref_cids, ref_scores) -> tuple[float, int]:
    """(max |score - plain|, chunk-id mismatches where the plain scores
    around a position are more than SCORE_TOL apart)."""
    import numpy as np

    check(cids.shape == ref_cids.shape, f"top-k shapes {cids.shape} and {ref_cids.shape}")
    err = float(np.abs(scores - ref_scores).max(initial=0.0))
    gap = np.abs(np.diff(ref_scores, axis=1)) > SCORE_TOL
    clear = np.ones(ref_scores.shape, bool)
    clear[:, :-1] &= gap
    clear[:, 1:] &= gap
    return err, int(((cids != ref_cids) & clear).sum())


def gpu_against_cpu(gpu, cpu, queries, label: str = BERT_MODEL) -> dict:
    """The GPU session held against a CPU session on the same index: the
    query-variant embeddings agree (cosine >= EMBED_COS_MIN) and each GPU
    vector list is an exact top-k of its own query vectors (kernel a against
    its plain version); the overlap of the two sessions' hit lists is
    reported, not gated (random-init embeddings make near-ties)."""
    import numpy as np
    import torch

    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.search import SearchOptions

    cos_min, emb_err, score_err, mism, overlaps = 1.0, 0.0, 0.0, 0, []
    for qtext, mode in queries:
        opts = SearchOptions(limit=10, mode=mode)
        st = gpu._prep_query(qtext, opts)
        ids, mask = st["feats"]
        qg = gpu.service.backend.encoder.encode(torch.from_numpy(ids).to(gpu.device),
                                                torch.from_numpy(mask).to(gpu.device)).cpu()
        qc = cpu.service.backend.encoder.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        cos_min = min(cos_min, float((qg * qc).sum(-1).min()))
        emb_err = max(emb_err, float((qg - qc).abs().max()))
        cids, scores = gpu.store.rows_to_ids(*gpu.store.dispatch(gpu.service.backend, ids,
                                                                 mask, st["fetch"]))
        dev = gpu.store._device
        k = min(st["fetch"], gpu.store._n_valid())
        ref = gpu.store.rows_to_ids(*ft.fused_cosine_topk_plain(qg.to(gpu.device), dev[1],
                                                                dev[3], k))
        e, m = check_exact_topk(cids, scores, *ref)
        score_err, mism = max(score_err, e), mism + m
        gpu._resp_cache.clear()
        cpu._resp_cache.clear()
        a = [h.chunk_id for h in gpu.search(qtext, opts).hits]
        b = [h.chunk_id for h in cpu.search(qtext, opts).hits]
        overlaps.append(len(set(a) & set(b)) / max(len(a), 1))
    out = {"queries": len(queries), "min_embedding_cosine": cos_min,
           "max_embedding_abs_err": emb_err, "max_vector_score_err": score_err,
           "vector_id_mismatches_off_near_ties": mism, "hit_overlap_top10": overlaps}
    log(f"GPU vs CPU session ({label}): {json.dumps(out)}")
    check(cos_min >= EMBED_COS_MIN, f"GPU and CPU query embeddings differ (cosine {cos_min})")
    check(score_err <= SCORE_TOL and mism == 0,
          "a GPU vector list is not an exact top-k of its own query vectors")
    return out


def direct_long_attention(device: str) -> None:
    """The encoder attention's long-sequence branch, which no bge-small
    bucket reaches: bge-small's heads (H=12, Dh=32) at S=2048 through
    ``fused_encoder_attention``; it must launch kernel e."""
    import torch

    from codesearch_tpu_torch.ops import attention as att

    q, k, v, mask = attention_inputs(8, 12, 2048, 32, seed=7, device=device)
    before = att.launch_counts["attention_flash"]
    out = att.fused_encoder_attention(q, k, v, mask)
    torch.cuda.synchronize()
    check(att.launch_counts["attention_flash"] == before + 1 and bool(torch.isfinite(out).all()),
          "the S=2048 encoder attention did not run kernel e to a finite result")


def open_session(db: Path, device: str) -> dict:
    """A GPU session and the seconds to open it and answer a first query
    (the corpus upload and first launches), which the p50s then leave out."""
    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    t = time.perf_counter()
    session = SearchSession(db, device=device)
    opened = time.perf_counter() - t
    probe = session.search("load the index and return it", SearchOptions(limit=10))
    check(len(probe.hits) == 10, "the first query returned too few hits")
    return {"session": session, "open_s": opened, "first_query_s": time.perf_counter() - t - opened}


def bert_synthetic(work: Path, n_rows: int, device: str) -> dict:
    """bge-small index -> hybrid, vector and identifier search on the card.
    Each path (indexing, the bf16 queries, the direct S=2048 call, the int8
    queries) is counted on its own, with the counts set to 0 just before it
    and read just after; no plain version may run in any of them."""
    import torch

    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.search import SearchSession

    db = work / "bert-synthetic-db"
    out: dict = {"launches": {}}
    with PlainCalls() as plain:
        reset_counts()
        built = build_synthetic(db, n_rows, device, model=BERT_MODEL)
        out["launches"]["index"] = launch_counts()
        index_by_seq = dict(att.launches_by_seq)
        warm_s = open_session(db, device)
        session = warm_s.pop("session")
        queries = {"hybrid": HYBRID_QUERIES, "vector": VECTOR_QUERIES,
                   "identifier": IDENT_QUERIES}
        reset_counts()
        res = {qtype: run_queries(session, qs, "vector" if qtype == "vector" else "hybrid")
               for qtype, qs in queries.items()}
        counts = out["launches"]["search"] = launch_counts()
        query_by_seq = dict(att.launches_by_seq)
        reset_counts()
        direct_long_attention(device)
        out["launches"]["direct"] = launch_counts()
    log(f"{BERT_MODEL} synthetic index: {n_rows} chunks in {built['seconds']:.2f} s "
        f"({built['chunks_per_s']:.1f} chunks/s, {built['tokens_per_s']:.0f} tokens/s, "
        f"{built['padded_tokens_per_s']:.0f} padded tokens/s), phases {built['phases_s']}; "
        f"attention launches by (kernel, S) while indexing: {index_by_seq}")
    kind, mat = session.store._device[0], session.store._device[1]
    check(kind == "bf16" and mat.device.type == "cuda", f"corpus is {kind} on {mat.device}")
    log(f"{BERT_MODEL} bf16 session open + first query {warm_s}")
    for qtype, (times, _hits, stages) in res.items():
        log(f"{BERT_MODEL} bf16 {qtype} queries: n={len(times)} p50 {statistics.median(times)} ms "
            f"max {max(times)} ms; session stages p50 ms {stage_medians(stages)}")
    log(f"{BERT_MODEL} bf16 launches by path: {out['launches']}; attention launches by "
        f"(kernel, S) during the queries: {query_by_seq}; plain versions called: "
        f"{dict(plain.calls)}")
    n_queries = sum(len(set(qs)) for qs in queries.values())
    check(not plain.calls, f"plain versions ran on the card: {dict(plain.calls)}")
    n_batches = -(-n_rows // BERT_BATCH)
    check(out["launches"]["index"]["attention_full"] >= BERT_LAYERS * n_batches,
          f"attention_full launched {out['launches']['index']['attention_full']} times "
          f"while indexing {n_batches} batches")
    check(counts["fused_cosine_topk"] >= n_queries,
          f"fused_cosine_topk launched {counts['fused_cosine_topk']} times for {n_queries} queries")
    check(counts["attention_full"] >= BERT_LAYERS * n_queries,
          f"attention_full launched {counts['attention_full']} times for {n_queries} queries")
    # c selects the dense BM25 leg, which the identifier's score plane (df
    # about n/3) puts in every identifier query; the other queries have none
    check(counts["fused_scores_topk"] >= len(set(IDENT_QUERIES)),
          f"fused_scores_topk launched {counts['fused_scores_topk']} times for "
          f"{len(set(IDENT_QUERIES))} identifier queries")
    check(out["launches"]["direct"]["attention_flash"] == 1,
          "the direct S=2048 call did not launch attention_flash once")
    out["bf16"] = {"p50_ms": {t: statistics.median(v[0]) for t, v in res.items()}}
    out["index"] = built
    for qtype in ("hybrid", "vector", "identifier"):
        mode = "vector" if qtype == "vector" else "hybrid"
        log(f"{BERT_MODEL} bf16 {qtype} profiled pass: "
            + json.dumps(device_busy_share(session, queries[qtype], mode)))
    cpu = SearchSession(db, device="cpu")
    out["gpu_vs_cpu"] = gpu_against_cpu(
        session, cpu, [(q, "hybrid") for q in HYBRID_QUERIES[:3] + IDENT_QUERIES[:2]]
        + [(q, "vector") for q in VECTOR_QUERIES[:2]])
    del cpu, session
    torch.cuda.empty_cache()

    set_int8(db, True)
    with PlainCalls() as plain:
        warm_s = open_session(db, device)
        session = warm_s.pop("session")
        int8_queries = {"hybrid": HYBRID_QUERIES[:4], "vector": VECTOR_QUERIES[:2]}
        reset_counts()
        res = {qtype: run_queries(session, qs, qtype) for qtype, qs in int8_queries.items()}
        counts = out["launches"]["int8_search"] = launch_counts()
    check(session.store._device[0] == "int8", "the int8 session's corpus is not int8")
    log(f"{BERT_MODEL} int8 session open + first query {warm_s}")
    for qtype, (times, _hits, stages) in res.items():
        log(f"{BERT_MODEL} int8 {qtype} queries: n={len(times)} p50 {statistics.median(times)} ms "
            f"max {max(times)} ms; session stages p50 ms {stage_medians(stages)}")
    log(f"{BERT_MODEL} int8 launches: {counts}; plain versions called: {dict(plain.calls)}")
    n_queries = sum(len(set(qs)) for qs in int8_queries.values())
    check(not plain.calls, f"plain versions ran on the card: {dict(plain.calls)}")
    check(counts["fused_cosine_topk_int8"] >= n_queries,
          f"fused_cosine_topk_int8 launched {counts['fused_cosine_topk_int8']} times")
    out["int8"] = {"p50_ms": {t: statistics.median(v[0]) for t, v in res.items()}}
    del session
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: serving on the card (waves, MCP, HTTP)
# ---------------------------------------------------------------------------

# 28 bare identifiers (six or seven variants each), 4 identifier queries
# with the high-df term (its score plane: the dense leg, kernel c) and 32
# plain hybrid queries: a wave of several hundred variant rows
WAVE_QUERIES = ([f"{v}_{o}" for v in VERBS[:7] for o in NOUNS[:4]]
                + [f"shared_registry {v}" for v in VERBS[:4]]
                + [f"{v} the {o} and return it" for v in VERBS[7:15] for o in NOUNS[4:8]])
WARM_QUERIES = ["warm the cache", "shared_registry warm"]
SERVE_LIMIT = 10
WAVE_REPEATS = 3        # the wall times are medians of 3 (the host clock spreads)


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _peak_reset(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_mb(device: str):
    import torch

    return torch.cuda.max_memory_allocated() / 2**20 if device == "cuda" else "not measured"


def wave_kernel_check(session, plans) -> tuple[dict, object]:
    """The wave's vector top-k kernel (a on a bf16 corpus, b on int8) held
    against its plain version at the wave's own shape: every query's variant
    rows stacked as ``search_many`` stacks them into [Qtot, d] query vectors,
    k the wave's deepest fetch. b must agree bit for bit, a as in phase 3
    (SCORE_TOL, no index mismatch away from near-ties). Returns the check's
    numbers and the stacked query vectors."""
    import numpy as np
    import torch

    from codesearch_tpu_torch.ops import fused_topk as ft

    tmax = max(p["feats"][0].shape[1] for p in plans)
    ids = np.zeros((sum(p["feats"][0].shape[0] for p in plans), tmax), np.int32)
    aux = np.zeros(ids.shape, plans[0]["feats"][1].dtype)
    row = 0
    for p in plans:
        f_ids, f_aux = p["feats"]
        ids[row:row + len(f_ids), :f_ids.shape[1]] = f_ids
        aux[row:row + len(f_ids), :f_ids.shape[1]] = f_aux
        row += len(f_ids)
    ids_t = torch.from_numpy(ids).to(session.device)
    aux_t = torch.from_numpy(aux).to(session.device)
    vecs = session.service.backend.embed_queries(ids_t, aux_t)
    kind, mat, scale, valid = session.store._device
    k = min(max(p["fetch"] for p in plans), session.store._n_valid())
    out = {"q": int(vecs.shape[0]), "k": k}
    if kind == "int8":
        got = ft.fused_cosine_topk_int8(vecs, mat, scale, valid, k)
        ref = ft.fused_cosine_topk_int8_plain(vecs, mat, scale, valid, k)
        same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        out.update(kernel="fused_cosine_topk_int8", values_and_indices_equal=same)
        log(f"kernel b at the wave's shape: {json.dumps(out)}")
        check(same, f"fused_cosine_topk_int8 disagrees at the wave's Q={out['q']} k={k}")
    else:
        got = ft.fused_cosine_topk(vecs, mat, valid, k)
        ref = ft.fused_cosine_topk_plain(vecs, mat, valid, k)
        plain_scores = torch.where(valid[None, :],
                                   vecs.to(torch.bfloat16).float() @ mat.float().T, ft.NEG_INF)
        err, row_err, mism = compare_cosine(
            got, ref, ft.fused_cosine_topk_plain(vecs, mat, valid, k + 1), plain_scores)
        del plain_scores
        out.update(kernel="fused_cosine_topk", max_abs_err=err, max_row_err=row_err,
                   index_mismatches_off_near_ties=mism)
        log(f"kernel a at the wave's shape: {json.dumps(out)}")
        check(err <= SCORE_TOL and row_err <= SCORE_TOL and mism == 0,
              f"fused_cosine_topk disagrees at the wave's Q={out['q']} k={k}")
    return out, vecs


def wave_against_sequential(session, queries, tag: str) -> dict:
    """Waves of ``queries`` through ``search_many`` against the same
    queries as sequential ``search`` calls on the same warm session (wall
    times: medians of ``WAVE_REPEATS`` passes each, uncached): every query
    must rank the same hits. The first wave runs with the counts set to 0
    just before it and read just after, under ``PlainCalls``; then a
    profiled wave gives the device time (idle share against the median
    wave's wall time) and peak memory, and the wave's vector top-k kernel
    is held against its plain version at the wave's shape."""
    from torch.profiler import ProfilerActivity, profile

    from codesearch_tpu_torch.search import SearchOptions

    device = session.device.type
    opts = SearchOptions(limit=SERVE_LIMIT)
    session.search_many(WARM_QUERIES, opts)     # corpus upload, first launches
    plans = [session._prep_query(q, opts) for q in queries]
    rows = sum(p["feats"][0].shape[0] for p in plans)
    seq_runs, wave_runs = [], []
    for _ in range(WAVE_REPEATS):
        session._resp_cache.clear()
        _sync(device)
        t = time.perf_counter()
        seq = [[h.chunk_id for h in session.search(q, opts).hits] for q in queries]
        _sync(device)
        seq_runs.append((time.perf_counter() - t) * 1000)
    _peak_reset(device)
    for rep in range(WAVE_REPEATS):
        session._resp_cache.clear()
        with PlainCalls() as plain:
            reset_counts()
            _sync(device)
            t = time.perf_counter()
            wave = session.search_many(queries, opts)
            _sync(device)
            wave_runs.append((time.perf_counter() - t) * 1000)
            if rep == 0:    # the counted window: the first wave alone
                counts, plain_calls = launch_counts(), dict(plain.calls)
    peak = _peak_mb(device)
    seq_ms, wave_ms = statistics.median(seq_runs), statistics.median(wave_runs)
    session._resp_cache.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        session.search_many(queries, opts)
        _sync(device)
    busy_ms, top = device_kernel_time(prof)
    got = [[h.chunk_id for h in r.hits] for r in wave]
    same = sum(a == b for a, b in zip(got, seq))
    out = {"queries": len(queries), "variant_rows": rows, "wave_ms": wave_ms,
           "sequential_ms": seq_ms, "speedup": seq_ms / wave_ms, "wave_runs_ms": wave_runs,
           "sequential_runs_ms": seq_runs,
           "device_busy_ms": busy_ms if device == "cuda" else "not measured",
           "idle_share": 1 - busy_ms / wave_ms if device == "cuda" else "not measured",
           "peak_memory_mb": peak, "top_device_ms": top, "same_hits_as_search": same}
    log(f"{tag} wave ({device}): {json.dumps(out)}; launches {counts}; plain versions called "
        f"{plain_calls}")
    check(device != "cuda" or busy_ms > 0, "the profiler saw no device time in the wave")
    check(device != "cuda" or not plain_calls, f"plain versions ran on the card: {plain_calls}")
    check(all(len(r.hits) == SERVE_LIMIT for r in wave), f"a {tag} wave query lacks hits")
    # the CPU's bf16 GEMMs round by row count, so a CPU rehearsal's
    # bge-small wave vectors move by about 1e-3 and random-init near-ties
    # reorder; the card's do not, and there every wave is held exactly
    exact = device == "cuda" or session.service.spec.kind == "hash"
    check(not exact or same == len(queries),
          f"{tag}: {len(queries) - same} wave queries rank other hits than their own search calls")
    out["kernel_at_wave_shape"], vecs = wave_kernel_check(session, plans)
    return {"counts": counts, "hits": got, "plans": plans, "vecs": vecs, **out}


def _summary(res: dict) -> dict:
    return {k: v for k, v in res.items() if k not in ("hits", "plans", "vecs")}


def serving_waves(work: Path, device: str) -> dict:
    """Waves on the GPU session: 64 hash queries (bf16; kernel a once, c on
    the dense leg), a subset held to the CPU session; 16 on the int8 corpus
    (kernel b once); 16 bge-small queries (one encoder forward: kernel d once
    a layer). Each wave's a or b is held against its plain version at the
    wave's shape."""
    import torch

    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    db = work / "synthetic-db"
    launches, out = {}, {}
    on_card = device == "cuda"
    set_int8(db, False)
    session = SearchSession(db, device=device)
    res = wave_against_sequential(session, WAVE_QUERIES, "code-hash-384 bf16")
    launches["wave"] = res.pop("counts")
    check(not on_card or launches["wave"]["fused_cosine_topk"] == 1,
          f"the wave launched kernel a {launches['wave']['fused_cosine_topk']} times, not once")
    check(not on_card or launches["wave"]["fused_scores_topk"] >= 1,
          "the wave's dense BM25 leg skipped c")
    check(session.fts.plane_builds > 0, "no score plane served the wave's dense leg")
    cpu = SearchSession(db, device="cpu")
    subset = [0, 1, 28, 33]
    cpu_hits = [[h.chunk_id for h in cpu.search(WAVE_QUERIES[i],
                                                 SearchOptions(limit=SERVE_LIMIT)).hits]
                for i in subset]
    check(cpu_hits == [res["hits"][i] for i in subset],
          "the GPU wave and the CPU session rank different hits")
    out["hash_bf16"] = _summary(res)
    del session, cpu, res
    if on_card:
        torch.cuda.empty_cache()

    set_int8(db, True)
    session = SearchSession(db, device=device)
    res = wave_against_sequential(session, WAVE_QUERIES[::4], "code-hash-384 int8")
    launches["int8_wave"] = res.pop("counts")
    check(session.store._device[0] == "int8", "the int8 session's corpus is not int8")
    check(not on_card or launches["int8_wave"]["fused_cosine_topk_int8"] == 1,
          "the int8 wave did not launch kernel b once")
    out["hash_int8"] = _summary(res)
    set_int8(db, False)
    del session, res
    if on_card:
        torch.cuda.empty_cache()

    # bge-small: the wave's encoder forward runs its GEMMs at another row
    # count than one query's, so its query vectors are also held to the
    # per-query ones (cosine >= WAVE_COS_MIN)
    bdb = work / "bert-synthetic-db"
    set_int8(bdb, False)
    session = SearchSession(bdb, device=device)
    res = wave_against_sequential(session, WAVE_QUERIES[::4], f"{BERT_MODEL} bf16")
    counts = launches["bert_wave"] = res.pop("counts")
    check(not on_card or (counts["attention_full"] == BERT_LAYERS
                          and counts["fused_cosine_topk"] == 1),
          f"the {BERT_MODEL} wave launched d {counts['attention_full']} times (want "
          f"{BERT_LAYERS}) and a {counts['fused_cosine_topk']} times (want 1)")
    enc = session.service.backend.encoder
    row, cos_min = 0, 1.0
    for p in res["plans"]:
        f_ids, f_mask = p["feats"]
        own = enc.encode(torch.from_numpy(f_ids).to(device), torch.from_numpy(f_mask).to(device))
        cos_min = min(cos_min, float((own * res["vecs"][row:row + len(f_ids)]).sum(-1).min()))
        row += len(f_ids)
    out["bert_bf16"] = {**_summary(res), "min_embedding_cosine": cos_min}
    log(f"{BERT_MODEL} bf16 wave's query vectors against per-query ones: min cosine {cos_min} "
        f"(limit {WAVE_COS_MIN})")
    check(not on_card or cos_min >= WAVE_COS_MIN,
          f"wave and per-query embeddings differ (cosine {cos_min})")
    del session, res
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": launches, **out}


def _serving_project(work: Path) -> Path:
    """A project directory whose ``.codesearch.db`` is the synthetic hash
    index, so the servers' own discovery finds it."""
    project = work / "serving-project"
    project.mkdir(exist_ok=True)
    link = project / ".codesearch.db"
    if not link.exists():
        link.symlink_to(work / "synthetic-db")
    return project


def _ranked_payload(stores, service, meta, query: str, limit: int, fmt) -> list:
    from codesearch_tpu_torch.server.readplane import ranked_chunks

    with stores.lock:
        return [fmt(m, s) for s, _c, m in ranked_chunks(stores, service, meta, query, limit)]


def serving_mcp(work: Path, device: str) -> dict:
    """MCP in process on the card: ``serve_stdio`` over the synthetic index,
    a pipelined group of 8 ``semantic_search`` calls (one wave), and
    ``find_references`` and ``index_status``; every answer equals
    ``ranked_chunks`` for its query."""
    import io

    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.index import read_metadata
    from codesearch_tpu_torch.index.manager import SharedStores
    from codesearch_tpu_torch.server.mcp import CodesearchService, serve_stdio

    db = _serving_project(work) / ".codesearch.db"
    service = EmbeddingService("code-hash-384", device=device)
    stores, lock = SharedStores.new_or_readonly(db, service.dims, device=device)
    try:
        svc = CodesearchService(db.parent, db, stores, service, None)
        queries = WAVE_QUERIES[3::8]
        reqs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/list"}]
        reqs += [{"jsonrpc": "2.0", "id": 10 + i, "method": "tools/call",
                  "params": {"name": "semantic_search",
                             "arguments": {"query": q, "limit": SERVE_LIMIT}}}
                 for i, q in enumerate(queries)]
        reqs += [{"jsonrpc": "2.0", "id": 30, "method": "tools/call",
                  "params": {"name": "find_references",
                             "arguments": {"symbol": "shared_registry"}}},
                 {"jsonrpc": "2.0", "id": 31, "method": "tools/call",
                  "params": {"name": "index_status", "arguments": {}}}]
        # first launches and the corpus upload outside the counted window
        svc.semantic_search({"query": WARM_QUERIES[0]})
        stdout = io.StringIO()
        with PlainCalls() as plain:
            reset_counts()
            _sync(device)
            t = time.perf_counter()
            serve_stdio(svc, stdin=io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n"),
                        stdout=stdout)
            _sync(device)
            ms = (time.perf_counter() - t) * 1000
            counts = launch_counts()
        frames = {f["id"]: f for f in map(json.loads, stdout.getvalue().splitlines())}
        check(sorted(frames) == sorted(r["id"] for r in reqs), f"MCP answered {sorted(frames)}")
        check("GPU-accelerated" in frames[1]["result"]["instructions"],
              "the MCP instructions do not name the GPU")
        check(len(frames[2]["result"]["tools"]) == 4, "tools/list lacks tools")
        meta = read_metadata(db)

        def fmt(m, s):
            item = {"path": m.path, "start_line": m.start_line + 1, "end_line": m.end_line,
                    "kind": m.kind, "score": round(s, 4)}
            if m.signature:
                item["signature"] = m.signature
            return item

        for i, q in enumerate(queries):
            got = json.loads(frames[10 + i]["result"]["content"][0]["text"])["results"]
            want = _ranked_payload(stores, service, meta, q, SERVE_LIMIT, fmt)
            check(got == want and len(got) == SERVE_LIMIT,
                  f"MCP semantic_search {q!r} differs from ranked_chunks")
        refs = json.loads(frames[30]["result"]["content"][0]["text"])["references"]
        status = json.loads(frames[31]["result"]["content"][0]["text"])
        check(refs and status["total_chunks"] == len(stores.store), f"MCP status {status}")
    finally:
        if lock is not None:
            lock.release()
    out = {"requests": len(reqs), "semantic_search_calls": len(queries), "round_trip_ms": ms}
    log(f"MCP ({device}): {json.dumps(out)}; launches {counts}; plain versions called "
        f"{dict(plain.calls)}")
    check(device != "cuda" or not plain.calls,
          f"plain versions ran on the card: {dict(plain.calls)}")
    check(device != "cuda" or counts["fused_cosine_topk"] == 1,
          f"the pipelined group launched kernel a {counts['fused_cosine_topk']} times, not once")
    return {"launches": {"mcp": counts}, "mcp": out}


def serving_http(work: Path, device: str) -> dict:
    """The HTTP server on the card (``make_server``, port 0): 16 concurrent
    hybrid POSTs coalesce into fewer waves than requests, one ``queries[]``
    body of 64, one ``mode=vector`` request (kernel a at Q=1); the hybrid
    answers equal ``ranked_chunks``. The burst's wall time includes the
    clients' threads (in this process); ``took_ms`` is each request's time
    in its handler."""
    import http.client
    import threading
    import urllib.request

    from codesearch_tpu_torch.index import read_metadata
    from codesearch_tpu_torch.server.http import SNIPPET_CHARS, make_server

    project = _serving_project(work)
    httpd, state = make_server(project, port=0, initial_index=False, device=device)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"

    def post(payload):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            conn.request("POST", "/search", json.dumps(payload).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            check(resp.status == 200, f"POST {payload} answered {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    try:
        # the initial refresh and the warmup (first launches) end first
        deadline = time.time() + 300
        while state.manager is not None and state.manager.status != "ready" \
                and time.time() < deadline:
            time.sleep(0.1)
        for t in threading.enumerate():
            if t.name == "search-warmup":
                t.join(timeout=300)
        check(state.manager is None or state.manager.status == "ready",
              f"the server's index manager is {state.manager.status}")
        meta = read_metadata(state.db)

        def fmt(m, s):
            return {"path": m.path, "start_line": m.start_line + 1, "end_line": m.end_line,
                    "kind": m.kind, "score": round(s, 4), "snippet": m.content[:SNIPPET_CHARS]}

        queries = WAVE_QUERIES[1::4]
        want = {q: _ranked_payload(state.stores, state.service, meta, q, SERVE_LIMIT, fmt)
                for q in queries}
        post({"query": WARM_QUERIES[1], "limit": SERVE_LIMIT, "mode": "hybrid"})
        waves0 = json.loads(urllib.request.urlopen(base + "/status").read())["batch_waves"]
        results, errors = [None] * len(queries), []
        barrier = threading.Barrier(len(queries))

        def worker(i):
            try:
                barrier.wait(timeout=60)
                results[i] = post({"query": queries[i], "limit": SERVE_LIMIT,
                                   "mode": "hybrid"})
            except Exception as e:  # reported below
                errors.append(e)

        with PlainCalls() as plain:
            reset_counts()
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(queries))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            burst_ms = (time.perf_counter() - t0) * 1000
            status = json.loads(urllib.request.urlopen(base + "/status").read())
            waves = status["batch_waves"] - waves0
            check(not errors and not any(t.is_alive() for t in threads),
                  f"concurrent POSTs failed: {errors[:3]}")
            for q, got in zip(queries, results):
                check(got["results"] == want[q], f"HTTP hybrid {q!r} differs from ranked_chunks")
            took = sorted(r["took_ms"] for r in results)
            t0 = time.perf_counter()
            batch = post({"queries": WAVE_QUERIES, "limit": SERVE_LIMIT, "mode": "hybrid"})
            batch_ms = (time.perf_counter() - t0) * 1000
            for item in batch["batch"][1::4]:
                check(item["results"] == want[item["query"]],
                      f"HTTP queries[] {item['query']!r} differs from ranked_chunks")
            check(len(batch["batch"]) == len(WAVE_QUERIES)
                  and all(len(b["results"]) == SERVE_LIMIT for b in batch["batch"]),
                  "the queries[] answer lacks results")
            batch_counts = launch_counts()
            reset_counts()
            t0 = time.perf_counter()
            vec = post({"query": "validate the schema and return it", "limit": SERVE_LIMIT})
            vector_ms = (time.perf_counter() - t0) * 1000
            vec_counts = launch_counts()
        check(device != "cuda" or not plain.calls,
              f"plain versions ran on the card: {dict(plain.calls)}")
        check(waves < len(queries), f"{len(queries)} concurrent requests took {waves} waves")
        check(vec["mode"] == "vector" and len(vec["results"]) == SERVE_LIMIT
              and all(-1.0 <= r["score"] <= 1.0 for r in vec["results"]),
              f"the vector request answered {vec['results'][:2]}")
        check(device != "cuda" or vec_counts["fused_cosine_topk"] == 1,
              "the vector request did not launch a once")
        out = {"concurrent_requests": len(queries), "batch_waves": waves, "burst_ms": burst_ms,
               "server_took_ms_p50": statistics.median(took), "server_took_ms_max": took[-1],
               "queries_body": len(WAVE_QUERIES), "queries_body_ms": batch_ms,
               "vector_ms": vector_ms}
        log(f"HTTP ({device}): {json.dumps(out)}; launches (burst + queries[]) {batch_counts}, "
            f"vector request {vec_counts}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        if state.manager is not None:
            state.manager.stop()
        if state._writer_lock is not None:
            state._writer_lock.release()
    total = {k: batch_counts[k] + vec_counts[k] for k in batch_counts}
    return {"launches": {"http": total}, "http": out}


def serving(work: Path, device: str) -> dict:
    res = serving_waves(work, device)
    mcp = serving_mcp(work, device)
    http = serving_http(work, device)
    res["launches"].update(mcp.pop("launches"))
    res["launches"].update(http.pop("launches"))
    return {**res, **mcp, **http}


# ---------------------------------------------------------------------------
# phase 10: Nomic, ModernBERT and neural reranking
# ---------------------------------------------------------------------------

NOMIC_MODEL = "nomic-v1.5"
NOMIC_ROWS = 65_536          # phase 5's corpus at a quarter of the rows
MODERNBERT_MODEL = "modernbert-large"
MODERNBERT_LAYERS = 6        # depth cut from 28: global layers 0 and 3, four local
MODERNBERT_ROWS = 8_192
MODERNBERT_CHECK_BATCH = 256
RERANKER = "jina-reranker-v1-turbo-en"
# GPU against CPU: final and pair scores, near-ties. Both forwards run bf16
# activations, and the rounding of the CLS state moves a pair score by the
# head's gain: at this checkpoint's (pooler and classifier at 1/sqrt(fan-in))
# a run on an NVIDIA H100 80GB HBM3 at 700.00 W read up to 1.9e-3 (absolute)
# and 2.2e-3 (ALiBi) against the CPU
RERANK_TOL = 5e-3


def nomic_synthetic(work: Path, n_rows: int, device: str) -> dict:
    """nomic-v1.5 as registered (random init from seed 0, one init shared
    by the GPU and the CPU session through the init cache): the synthetic
    index, hybrid, vector and identifier queries, each path counted on its
    own with no plain version called (d once a layer of every index batch
    and every distinct query, a for every query, c for the identifiers'
    dense leg), the idle share, and the GPU session against a CPU one."""
    import torch

    from codesearch_tpu_torch.embed.service import _default_batch_size
    from codesearch_tpu_torch.models import MODELS
    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.search import SearchSession

    spec = MODELS[NOMIC_MODEL]
    db = work / "nomic-synthetic-db"
    out: dict = {"launches": {}}
    t = time.perf_counter()
    with PlainCalls() as plain:
        reset_counts()
        built = build_synthetic(db, n_rows, device, model=NOMIC_MODEL)
        out["launches"]["nomic_index"] = launch_counts()
        index_by_seq = dict(att.launches_by_seq)
        warm = open_session(db, device)
        session = warm.pop("session")
        queries = {"hybrid": HYBRID_QUERIES, "vector": VECTOR_QUERIES,
                   "identifier": IDENT_QUERIES}
        reset_counts()
        res = {qtype: run_queries(session, qs, "vector" if qtype == "vector" else "hybrid")
               for qtype, qs in queries.items()}
        counts = out["launches"]["nomic_search"] = launch_counts()
        query_by_seq = dict(att.launches_by_seq)
    log(f"{NOMIC_MODEL} synthetic index (init and index {time.perf_counter() - t:.2f} s): "
        f"{n_rows} chunks in {built['seconds']:.2f} s ({built['chunks_per_s']:.1f} chunks/s, "
        f"{built['tokens_per_s']:.0f} tokens/s, {built['padded_tokens_per_s']:.0f} padded "
        f"tokens/s), phases {built['phases_s']}; attention launches by (kernel, S) while "
        f"indexing: {index_by_seq}")
    log(f"{NOMIC_MODEL} session open + first query {warm}")
    for qtype, (times, _hits, stages) in res.items():
        log(f"{NOMIC_MODEL} {qtype} queries: n={len(times)} p50 {statistics.median(times)} ms "
            f"max {max(times)} ms; session stages p50 ms {stage_medians(stages)}")
    log(f"{NOMIC_MODEL} launches by path: {out['launches']}; attention launches by (kernel, S) "
        f"during the queries: {query_by_seq}; plain versions called: {dict(plain.calls)}")
    out["index"] = built
    out["p50_ms"] = {qtype: statistics.median(v[0]) for qtype, v in res.items()}
    out["hybrid_stages_p50_ms"] = stage_medians(res["hybrid"][2])
    if device == "cuda":
        layers = spec.arch.layers
        n_batches = -(-n_rows // _default_batch_size(spec.dims))
        n_queries = sum(len(set(qs)) for qs in queries.values())
        check(not plain.calls, f"plain versions ran on the card: {dict(plain.calls)}")
        check(out["launches"]["nomic_index"]["attention_full"] >= layers * n_batches,
              f"attention_full launched {out['launches']['nomic_index']['attention_full']} "
              f"times while indexing {n_batches} batches")
        check(counts["attention_full"] >= layers * n_queries,
              f"attention_full launched {counts['attention_full']} times for {n_queries} queries")
        check(counts["fused_cosine_topk"] >= n_queries,
              f"fused_cosine_topk launched {counts['fused_cosine_topk']} times")
        check(counts["fused_scores_topk"] >= len(set(IDENT_QUERIES)),
              f"fused_scores_topk launched {counts['fused_scores_topk']} times")
        out["hybrid_profile"] = device_busy_share(session, HYBRID_QUERIES, "hybrid")
        log(f"{NOMIC_MODEL} hybrid profiled pass: {json.dumps(out['hybrid_profile'])}")
    cpu = SearchSession(db, device="cpu")
    out["gpu_vs_cpu"] = gpu_against_cpu(
        session, cpu, [(q, "hybrid") for q in HYBRID_QUERIES[:3] + IDENT_QUERIES[:2]]
        + [(q, "vector") for q in VECTOR_QUERIES[:2]], label=NOMIC_MODEL)
    del cpu, session
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def modernbert_synthetic(work: Path, device: str, n_rows: int, batch: int) -> dict:
    """modernbert-large at full width, depth cut to ``MODERNBERT_LAYERS``
    (the registry's entry is swapped for the phase): a batch of ``batch``
    chunks through the GPU encoder against the CPU forward (cosine per row,
    d exactly once a global layer and the windowed kernel once a local layer
    a forward, no plain version and no composed route), then an index of
    ``n_rows`` chunks and hybrid queries with the same counts per
    forward."""
    import dataclasses

    import torch

    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.embed.service import _default_batch_size, prepare_text
    from codesearch_tpu_torch.models import encoder as enc
    from codesearch_tpu_torch.models import registry

    spec = registry.MODELS[MODERNBERT_MODEL]
    cfg = dataclasses.replace(spec.arch, layers=MODERNBERT_LAYERS)
    n_global = sum(1 for i in range(cfg.layers) if i % cfg.global_every == 0)
    n_local = cfg.layers - n_global
    out: dict = {"launches": {}, "layers": cfg.layers, "global_layers": n_global}
    registry.MODELS[MODERNBERT_MODEL] = dataclasses.replace(spec, arch=cfg)
    try:
        t = time.perf_counter()
        svc = EmbeddingService(MODERNBERT_MODEL, use_persistent_cache=False, device=device)
        out["init_s"] = time.perf_counter() - t
        texts = [prepare_text(c) for c in synthetic_chunks(0, batch)]
        ids, mask = svc.backend.featurize_queries(texts)
        with PlainCalls() as plain:
            reset_counts()
            vecs = svc.backend.encoder.encode(torch.from_numpy(ids).to(device),
                                              torch.from_numpy(mask).to(device)).cpu()
            fwd = route_counts()
            fwd_plain = dict(plain.calls)
        out["launches"]["modernbert_forward"] = fwd
        cpu = enc.BertEncoder(cfg, enc.cached_init_params(cfg), device="cpu")
        t = time.perf_counter()
        ref = cpu.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        cpu_s = time.perf_counter() - t
        cos = (vecs * ref).sum(-1)
        out["forward"] = {"batch": batch, "seq": int(ids.shape[1]),
                          "min_cosine": float(cos.min()), "cpu_forward_s": cpu_s,
                          "launches": fwd, "plain_calls": fwd_plain}
        log(f"{MODERNBERT_MODEL} ({cfg.layers} layers) forward of {batch} chunks at S="
            f"{ids.shape[1]}: GPU against CPU min cosine {float(cos.min())} (CPU forward "
            f"{cpu_s:.2f} s); launches {fwd}; plain versions called {fwd_plain}")
        check(float(cos.min()) >= EMBED_COS_MIN,
              f"the {MODERNBERT_MODEL} GPU forward differs from the CPU one")
        del cpu
        if device == "cuda":
            check(fwd["attention_full"] == n_global and fwd["attention_window"] == n_local
                  and fwd["composed_window"] == 0 and fwd["composed_bias2d"] == 0,
                  f"a {MODERNBERT_MODEL} forward ran d {fwd['attention_full']} times and the "
                  f"windowed kernel {fwd['attention_window']} times")
            check(not fwd_plain, f"plain versions in a {MODERNBERT_MODEL} forward: {fwd_plain}")

        db = work / "modernbert-synthetic-db"
        with PlainCalls() as plain:
            reset_counts()
            built = build_synthetic(db, n_rows, device, model=MODERNBERT_MODEL)
            idx = route_counts()
            idx_plain = dict(plain.calls)
            warm = open_session(db, device)
            session = warm.pop("session")
            reset_counts()
            before = collections.Counter(plain.calls)
            times, _, stages = run_queries(session, HYBRID_QUERIES[:4], "hybrid")
            qc = route_counts()
            q_plain = dict(plain.calls - before)
        out["launches"]["modernbert_index"] = idx
        out["launches"]["modernbert_search"] = qc
        out["index"] = built
        out["hybrid_p50_ms"] = statistics.median(times)
        out["hybrid_stages_p50_ms"] = stage_medians(stages)
        log(f"{MODERNBERT_MODEL} synthetic index: {n_rows} chunks in {built['seconds']:.2f} s "
            f"({built['chunks_per_s']:.1f} chunks/s, {built['tokens_per_s']:.0f} tokens/s); "
            f"launches {idx}, plain versions called {idx_plain}; hybrid p50 "
            f"{out['hybrid_p50_ms']} ms, stages {out['hybrid_stages_p50_ms']}; query launches "
            f"{qc}, plain versions called {q_plain}")
        if device == "cuda":
            forwards = -(-n_rows // _default_batch_size(spec.dims))
            for what, c, pc, n in (("index", idx, idx_plain, forwards),
                                   ("queries", qc, q_plain, len(set(HYBRID_QUERIES[:4])))):
                check(c["attention_full"] == n_global * n
                      and c["attention_window"] == n_local * n and c["composed_window"] == 0,
                      f"{MODERNBERT_MODEL} {what}: d {c['attention_full']} and the windowed "
                      f"kernel {c['attention_window']} times for {n} forwards")
                check(not pc, f"plain versions in {MODERNBERT_MODEL} {what}: {pc}")
            check(qc["fused_cosine_topk"] >= len(set(HYBRID_QUERIES[:4])),
                  "fused_cosine_topk did not run for every ModernBERT query")
        del session, svc
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        registry.MODELS[MODERNBERT_MODEL] = spec
    return out


def write_cross_encoder(model_dir: Path, alibi: bool, seed: int = 0) -> None:
    """A cross-encoder checkpoint of ``CROSS_ENCODER_ARCH``'s shape (6
    layers, hidden 384, 12 heads of 32) from the port's random init at
    ``seed``, with a pooler and a classifier (normal at 1/sqrt(fan-in)),
    under Hugging Face BERT names with its config.json; ``alibi`` writes the
    jina-reranker form (no position table)."""
    import dataclasses

    import numpy as np
    from safetensors.numpy import save_file

    from codesearch_tpu_torch.models import encoder as enc
    from codesearch_tpu_torch.models.cross_encoder import CROSS_ENCODER_ARCH

    cfg = dataclasses.replace(CROSS_ENCODER_ARCH,
                              position_type="alibi" if alibi else "absolute")
    tree = enc.init_params(cfg, seed)
    rng = np.random.default_rng(seed)
    h, emb = cfg.hidden, tree["embeddings"]
    t = {"embeddings.word_embeddings.weight": emb["word"],
         "embeddings.token_type_embeddings.weight": emb["token_type"],
         "embeddings.LayerNorm.weight": emb["ln_scale"],
         "embeddings.LayerNorm.bias": emb["ln_bias"],
         "bert.pooler.dense.weight": (rng.standard_normal((h, h)) / h ** 0.5).astype(np.float32),
         "bert.pooler.dense.bias": np.zeros(h, np.float32),
         "classifier.weight": (rng.standard_normal((1, h)) / h ** 0.5).astype(np.float32),
         "classifier.bias": np.zeros(1, np.float32)}
    if not alibi:
        t["embeddings.position_embeddings.weight"] = emb["position"]
    for i, layer in enumerate(tree["layers"]):
        for ours, theirs in enc.HF_LAYER_MAP.items():
            arr = layer[ours].T if ours.endswith("_w") else layer[ours]
            t[f"encoder.layer.{i}.{theirs}"] = np.ascontiguousarray(arr)
    model_dir.mkdir(parents=True, exist_ok=True)
    save_file(t, str(model_dir / "model.safetensors"))
    (model_dir / "config.json").write_text(json.dumps({
        "architectures": ["BertForSequenceClassification"], "model_type": "bert",
        "vocab_size": cfg.vocab_size, "hidden_size": h, "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads, "intermediate_size": cfg.intermediate,
        "max_position_embeddings": cfg.max_len, "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu",
        "position_embedding_type": cfg.position_type}))


def ranked_alike(got, want, tol: float) -> int:
    """Positions where two ranked hit lists name different chunks although
    ``want``'s scores around the position are more than ``tol`` apart
    (``want`` holds one hit more than ``got``, for the last position)."""
    ws = [h.score for h in want]
    bad = 0
    for i, h in enumerate(got):
        if h.chunk_id != want[i].chunk_id:
            near = ((i > 0 and ws[i - 1] - ws[i] <= tol)
                    or (i + 1 < len(ws) and ws[i] - ws[i + 1] <= tol))
            bad += not near
    return bad


def rerank_phase(work: Path, device: str, queries: list) -> dict:
    """``search --rerank`` (limit 10, the default 100 candidates) on phase
    5's hash index through a GPU and a CPU session, in three modes: the
    weights-free proxy, a cross-encoder checkpoint with absolute positions
    (d once a layer a query) and an ALiBi one (the biased route once a
    layer, no d). The GPU session ranks the CPU session's hits off
    near-ties, its final scores and its pair scores within RERANK_TOL."""
    import numpy as np
    import torch

    from codesearch_tpu_torch.search import SearchOptions, SearchSession
    from codesearch_tpu_torch.utils.constants import get_global_models_cache_dir

    db = work / "synthetic-db"
    model_dir = get_global_models_cache_dir() / RERANKER
    out: dict = {"launches": {}, "tolerance": RERANK_TOL}
    for mode in ("proxy", "absolute", "alibi"):
        shutil.rmtree(model_dir, ignore_errors=True)
        if mode != "proxy":
            write_cross_encoder(model_dir, alibi=mode == "alibi")
        gpu, cpu = SearchSession(db, device=device), SearchSession(db, device="cpu")
        gpu.search("warm the session", SearchOptions(limit=10))
        with PlainCalls() as plain:
            reset_counts()
            got = [gpu.search(q, SearchOptions(limit=10, rerank=True)) for q in queries]
            counts = route_counts()
        out["launches"][f"rerank_{mode}"] = counts
        want = [cpu.search(q, SearchOptions(limit=11, rerank=True)) for q in queries]
        mismatches = sum(ranked_alike(g.hits, w.hits, RERANK_TOL) for g, w in zip(got, want))
        final_err = max(float(np.abs(np.array([h.score for h in g.hits])
                                     - np.array([h.score for h in w.hits[:len(g.hits)]])).max())
                        for g, w in zip(got, want))
        # pair scores of one query's candidates, on each device
        cands = cpu.search(queries[0], SearchOptions(limit=100)).hits
        docs = [h.signature or h.content[:512] for h in cands]
        pair_err = float(np.abs(gpu.reranker.model.score_pairs(queries[0], docs)
                                - cpu.reranker.model.score_pairs(queries[0], docs)).max())
        r = gpu.reranker
        row = {"rerank_mode": got[0].rerank_mode, "pairs": len(docs),
               "rerank_ms_p50": statistics.median(g.timings_ms["rerank"] for g in got),
               "total_ms_p50": statistics.median(g.timings_ms["total"] for g in got),
               "cpu_rerank_ms_p50": statistics.median(w.timings_ms["rerank"] for w in want),
               "gate_open_rate": r.gate_open / max(r.gate_calls, 1),
               "rank_mismatches_off_near_ties": mismatches, "max_final_score_err": final_err,
               "max_pair_score_err": pair_err, "launches": counts,
               "plain_calls": dict(plain.calls)}
        out[mode] = row
        log(f"search --rerank ({mode}) on the {device} session: {json.dumps(row)}")
        expected = "proxy-bi-encoder" if mode == "proxy" else "cross-encoder"
        check(all(g.rerank_mode == expected == w.rerank_mode for g, w in zip(got, want)),
              f"rerank mode is not {expected}")
        check(mismatches == 0 and final_err <= RERANK_TOL and pair_err <= RERANK_TOL,
              f"the GPU session reranks ({mode}) unlike the CPU session")
        if device == "cuda":
            layers = gpu.reranker.model.cfg.layers if mode != "proxy" else 0
            d_want = layers * len(queries) if mode == "absolute" else 0
            b_want = layers * len(queries) if mode == "alibi" else 0
            check(counts["attention_full"] == d_want and counts["composed_bias2d"] == b_want
                  and counts["composed_window"] == 0,
                  f"rerank ({mode}): d {counts['attention_full']} (want {d_want}), the biased "
                  f"route {counts['composed_bias2d']} (want {b_want})")
            check(dict(plain.calls) == ({"reference_attention": b_want} if b_want else {}),
                  f"plain versions in rerank ({mode}): {dict(plain.calls)}")
            check(counts["fused_cosine_topk"] >= len(queries),
                  f"rerank ({mode}) queries did not run kernel a")
        del gpu, cpu
        if device == "cuda":
            torch.cuda.empty_cache()
    shutil.rmtree(model_dir, ignore_errors=True)
    return out


def kernel_d_at_rotary_shapes(device: str) -> dict:
    """Kernel d at the rotary encoders' index batches (Dh=64, the 64-token
    bucket, ragged masks): nomic-v1.5's B=128, H=12 and ModernBERT's B=64,
    H=16, held against its plain twin, with CUDA events (plain-kernel-
    kernel-plain), device ms, its bound and ``scaled_dot_product_attention``."""
    import torch

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.ops import attention as att

    out = {}
    for label, (b, h) in ((NOMIC_MODEL, (128, 12)), (MODERNBERT_MODEL, (64, 16))):
        q, k, v, mask = attention_inputs(b, h, 64, 64, seed=h, device=device)
        got = att.attention_full(q, k, v, mask)
        ref = att.attention_full_plain(q, k, v, mask)
        err, _, ok = compare_attention(got, ref)
        check(ok and bool(torch.isfinite(got).all()),
              f"attention_full disagrees with its plain version at {label}'s shape")
        t_plain_1 = cuda_ms(lambda: att.attention_full_plain(q, k, v, mask), reps=10)
        t_kern_1 = cuda_ms(lambda: att.attention_full(q, k, v, mask), reps=10)
        t_kern_2 = cuda_ms(lambda: att.attention_full(q, k, v, mask), reps=10)
        t_plain_2 = cuda_ms(lambda: att.attention_full_plain(q, k, v, mask), reps=10)
        row = {"shape": [b, h, 64, 64], "max_abs_err": err, "ms": min(t_kern_1, t_kern_2),
               "plain_ms": min(t_plain_1, t_plain_2), **attention_bound(q, mask),
               "library_ms": sdpa_ms(q, k, v, mask),
               "device_ms": device_ms(lambda: att.attention_full(q, k, v, mask)),
               "library_device_ms": device_ms(sdpa_call(q, k, v, mask))}
        log(f"time attention_full at {label}'s index batch B={b} H={h} S=64 Dh=64 (ragged "
            f"masks): {json.dumps(row)}")
        out[label] = row
    return out


def encoder_family(work: Path, device: str) -> dict:
    """Phase 10: Nomic, ModernBERT and ``search --rerank`` on the card."""
    t0 = time.perf_counter()
    d_times = kernel_d_at_rotary_shapes(device)
    nomic = nomic_synthetic(work, NOMIC_ROWS, device)
    t1 = time.perf_counter()
    modernbert = modernbert_synthetic(work, device, MODERNBERT_ROWS, MODERNBERT_CHECK_BATCH)
    t2 = time.perf_counter()
    rerank = rerank_phase(work, device, HYBRID_QUERIES)
    t3 = time.perf_counter()
    seconds = {"nomic": t1 - t0, "modernbert": t2 - t1, "rerank": t3 - t2, "total": t3 - t0}
    log(f"phase 10 seconds: {seconds}")
    launches = {**nomic.pop("launches"), **modernbert.pop("launches"), **rerank.pop("launches")}
    return {"nomic": nomic, "modernbert": modernbert, "rerank": rerank, "seconds": seconds,
            "launches": launches, "d_at_rotary_shapes": d_times}


# ---------------------------------------------------------------------------
# phase 15: a checkpoint read onto the card
# ---------------------------------------------------------------------------

CHECKPOINT_MODELS = ("nomic-v1.5", "modernbert-large")
CHECKPOINT_SEED = 1500000001


def host_path_tree(path: Path, cfg) -> dict:
    """The host path ``load_safetensors`` replaced, for its time and memory
    only: every tensor read as numpy by ``safetensors`` and widened to f32,
    the dense kernels transposed and laid out on the host; ``BertEncoder``
    then uploads each leaf as f32 from pageable memory and casts it there."""
    import numpy as np
    import torch
    from safetensors import safe_open

    from codesearch_tpu_torch.models import encoder as enc

    with safe_open(str(path), framework="np") as f:
        raw = {k: torch.from_numpy(np.array(f.get_tensor(k), np.float32)) for k in f.keys()}
    flat = enc.flatten_params(enc.checkpoint_params(raw, cfg))
    return enc.unflatten_params({k: np.ascontiguousarray(v.numpy()) for k, v in flat.items()})


def plain_fill(f, blob) -> None:
    """The simpler fill the reader's ring is held against: the whole data
    section into one pageable host tensor, then one copy to ``blob``."""
    import torch

    from codesearch_tpu_torch.models import encoder as enc

    host = torch.empty(blob.numel(), dtype=torch.uint8)
    enc._read_into(f, memoryview(host.numpy()))
    blob.copy_(host)


def timed_reads(path: Path, device: str, turns: int = 3) -> dict:
    """Seconds of ``read_safetensors(path, device)`` with the ring's fill
    and with ``plain_fill``, in turns (ring, plain, plain, ring), after one
    read that pins the ring."""
    import torch

    from codesearch_tpu_torch.models import encoder as enc

    ring_fill, out = enc._fill, {"ring": [], "plain": []}
    try:
        for i, side in enumerate(["ring"] + ["ring", "plain", "plain", "ring"] * turns):
            enc._fill = ring_fill if side == "ring" else plain_fill
            _sync(device)
            t = time.perf_counter()
            tensors = enc.read_safetensors(path, device)
            _sync(device)
            if i:
                out[side].append(time.perf_counter() - t)
            del tensors
    finally:
        enc._fill = ring_fill
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _state_bits(module) -> dict:
    import torch

    out = {}
    for name, t in (*module.named_buffers(), *module.named_parameters()):
        ints = torch.int16 if t.element_size() == 2 else torch.int32
        out[name] = t.detach().view(ints)
    return out


def timed_encoder_build(path: Path, cfg, device: str, staged: bool) -> tuple:
    """(encoder, seconds, device bytes above the start at the peak) of one
    build from ``path``: through ``load_safetensors`` (``staged``) or
    through ``host_path_tree``; the checkpoint's bytes dropped after."""
    import torch

    from codesearch_tpu_torch.models import encoder as enc

    _sync(device)
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    _peak_reset(device)
    t = time.perf_counter()
    tree = enc.load_safetensors(path, cfg, device) if staged else host_path_tree(path, cfg)
    model = enc.BertEncoder(cfg, tree, device=device)
    del tree
    _sync(device)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base if device == "cuda" else "not measured"
    return model, seconds, peak


def checkpoint_phase(work: Path, device: str) -> dict:
    """Phase 15: the nomic-v1.5 and modernbert-large checkpoints the
    benchmark writes (seeded, fp16, ``bench_cells.gen.weights``) read by
    ``read_safetensors`` onto the card (pinned ring) and onto the CPU (one
    straight read): every tensor byte-equal; the ring's read against a
    plain one (``timed_reads``). The encoder built by
    ``load_safetensors`` on the card equals, buffer for buffer, the one the
    host path builds (``host_path_tree``). Each load's seconds, bytes/s and
    device peak above its start, the two paths in turns (staged, host,
    host, staged), the file warm in the page cache."""
    import torch

    from bench_cells.gen.weights import make_weights, write_checkpoint
    from bench_cells.harness import HERE, model_dims
    from codesearch_tpu_torch.models import encoder as enc
    from codesearch_tpu_torch.models.registry import MODELS

    out = {}
    for name in CHECKPOINT_MODELS:
        dims = model_dims(json.loads((HERE / "configs" / f"{name}.json").read_text()))
        path = work / "checkpoints" / name / "model.safetensors"
        write_checkpoint(make_weights(dims, CHECKPOINT_SEED, device), path)
        cfg = MODELS[name].arch
        on_card, on_host = enc.read_safetensors(path, device), enc.read_safetensors(path, "cpu")
        check(sorted(on_card) == sorted(on_host), f"{name}: the two reads hold other tensors")
        for k, t in on_host.items():
            check(t.dtype == on_card[k].dtype and t.shape == on_card[k].shape
                  and torch.equal(on_card[k].cpu().view(torch.uint8),
                                  t.contiguous().view(torch.uint8)),
                  f"{name}: {k} read onto the card differs from the CPU read")
        n_bytes, n_tensors = path.stat().st_size, len(on_host)
        del on_card, on_host
        reads = timed_reads(path, device)
        runs = {"staged": [], "host": []}
        built = {}
        for staged in (True, False, False, True):
            model, seconds, peak = timed_encoder_build(path, cfg, device, staged)
            runs["staged" if staged else "host"].append({"seconds": seconds, "peak_bytes": peak})
            built.setdefault(staged, _state_bits(model))
            del model
            if device == "cuda":
                torch.cuda.empty_cache()
        want, got = built[False], built[True]
        check(sorted(got) == sorted(want), f"{name}: the two encoders hold other buffers")
        for k in want:
            check(torch.equal(got[k], want[k]), f"{name}: {k} differs from the host path's")
        res = {"file_bytes": n_bytes, "tensors": n_tensors, "buffers": len(want),
               "read": {side: {"seconds": v, "median_bytes_per_s": n_bytes / statistics.median(v)}
                        for side, v in reads.items()}}
        for side, rs in runs.items():
            best = min(r["seconds"] for r in rs)
            res[side] = {"seconds": [r["seconds"] for r in rs], "bytes_per_s": n_bytes / best,
                         "peak_bytes": [r["peak_bytes"] for r in rs]}
        out[name] = res
        log(f"phase 15 {name}: {json.dumps(res)}")
    return out


# ---------------------------------------------------------------------------
# phase 11: training on the card
# ---------------------------------------------------------------------------

TRAIN_EPOCHS = 3            # `train --epochs` (the CLI's default is 15)
TRAIN_LOSS_RTOL = 1e-3      # per-epoch losses, the card against the CPU
TABLE_EQUAL_MIN = 0.99      # equal bf16 entries in the rows either run touched
TRAIN_QUERIES = ["exact cosine top-k over the corpus", "return the tensor on the device",
                 "parse the config and return it", "self tensor shape dtype",
                 "train the hash table on mined pairs", "cross encoder pair scores",
                 "kernel launch counts", "torch float device return self"]
CONTRASTIVE_BATCH = 64
CONTRASTIVE_LEN = 128
CONTRASTIVE_STEPS = 10
STEP_LOSS_RTOL = 1e-2       # one contrastive step, the card against the CPU
STEP_GRAD_COS_MIN = 0.99    # its gradients, per parameter


def _force_device_routes(session) -> None:
    """The small index of the port's sources would take the host paths (few
    rows, few documents); these knobs (the tests' own) send its searches
    through the device routes: kernel a over the corpus, the dense BM25
    leg (kernel c) for terms in more than 64 chunks."""
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    session.fts.plane_df_floor = 64


def _platform(device: str) -> list:
    """The CLI's device arguments: none for the card (its default)."""
    return ["--platform", "cpu"] if device == "cpu" else []


def _searches(db: Path, device: str, limit: int) -> list:
    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    session = SearchSession(db, device=device)
    _force_device_routes(session)
    return [session.search(q, SearchOptions(limit=limit)) for q in TRAIN_QUERIES]


def _chunk_count(db: Path) -> int:
    from codesearch_tpu_torch.vectordb import VectorStore

    return len(VectorStore(db, dims=DIMS, readonly=True, device="cpu"))


def _mined(db: Path, device: str) -> list:
    from codesearch_tpu_torch.train.data import mine_pairs
    from codesearch_tpu_torch.vectordb import VectorStore

    store = VectorStore(db, dims=DIMS, readonly=True, device=device)
    return mine_pairs([m for _, m in store.iter_chunks()])


def train_hash_phase(work: Path, device: str) -> dict:
    """11a: ``codesearch-torch train`` (the CLI in this process) on phase
    4's index of the port's sources, on the card, and with ``--platform
    cpu`` on a copy of that index: per-epoch losses within TRAIN_LOSS_RTOL,
    the saved tables' bf16 entries equal in TABLE_EQUAL_MIN of the touched
    rows, the searches over the re-indexed corpus ranked as a CPU session's
    on the same index off near-ties (the CPU-trained index's ranking and
    score differences logged beside), kernels a and c launched by them, as
    many chunks as before ``train`` and no hit twice."""
    import numpy as np

    from codesearch_tpu_torch.cli.main import main as cli
    from codesearch_tpu_torch.models import hash_embedder as he
    from codesearch_tpu_torch.train import hash_finetune

    db, db_cpu = work / "self-db-code-hash-384", work / "self-db-cpu"
    shutil.copytree(db, db_cpu)
    src = str(ROOT / "codesearch_tpu_torch")
    losses: list = []
    finetune = hash_finetune.finetune_table

    def recorded(*args, **kw):          # the CLI's losses, epoch by epoch
        table, epoch_losses = finetune(*args, **kw)
        losses.append(epoch_losses)
        return table, epoch_losses

    hash_finetune.finetune_table = recorded
    chunks_before = _chunk_count(db)
    try:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli(["-q", *_platform(device), "--store", str(db), "train", src,
                  "--epochs", str(TRAIN_EPOCHS)])
        t1 = time.perf_counter()
        train_counts = launch_counts()
        rc_cpu = cli(["-q", "--platform", "cpu", "--store", str(db_cpu), "train", src,
                      "--epochs", str(TRAIN_EPOCHS)])
        t2 = time.perf_counter()
    finally:
        hash_finetune.finetune_table = finetune
    check(rc == 0 and rc_cpu == 0, f"train exited {rc} on {device}, {rc_cpu} on the CPU")
    gpu_l, cpu_l = (np.array(ls) for ls in losses)
    loss_rel = float(np.abs(gpu_l - cpu_l).max() / np.abs(cpu_l).min())
    default = he.make_table(DIMS, device="cpu").float().numpy()
    got = he.load_table_host(db / "hash_table.npz", DIMS)
    want = he.load_table_host(db_cpu / "hash_table.npz", DIMS)
    touched = (got != default).any(axis=1) | (want != default).any(axis=1)
    equal_share = float((got[touched] == want[touched]).mean())
    reset_counts()
    with PlainCalls() as plain:
        hits = _searches(db, device, 10)
        search_counts = launch_counts()
    # the card's index searched on the CPU (the plain versions, the same
    # trained table), and the CPU-trained index: the two tables differ in the
    # bf16 entries counted above, so its scores move by more than a near-tie
    ref = _searches(db, "cpu", 11)
    mismatches = sum(ranked_alike(g.hits, w.hits, 1e-4) for g, w in zip(hits, ref))
    cpu_trained = _searches(db_cpu, "cpu", 11)
    cross = sum(ranked_alike(g.hits, w.hits, 1e-4) for g, w in zip(hits, cpu_trained))
    cross_err = max((abs(h.score - w.score) for g, c in zip(hits, cpu_trained)
                     for h in g.hits for w in c.hits if w.chunk_id == h.chunk_id), default=0.0)
    # the re-index replaced the untrained rows: as many chunks as before,
    # and no chunk in a search's hits twice
    chunks_after = {"device": _chunk_count(db), "cpu": _chunk_count(db_cpu)}
    repeated = sum(len(r.hits) - len({(h.path, h.start_line) for h in r.hits})
                   for r in hits + ref + cpu_trained)
    out = {"chunks_before": chunks_before, "chunks_after": chunks_after,
           "repeated_hits": repeated, "pairs": len(_mined(db_cpu, "cpu")),
           "epochs": TRAIN_EPOCHS,
           "losses": gpu_l.tolist(), "cpu_losses": cpu_l.tolist(), "loss_max_rel_err": loss_rel,
           "touched_rows": int(touched.sum()), "table_equal_share": equal_share,
           "train_and_reindex_s": t1 - t0, "cpu_train_and_reindex_s": t2 - t1,
           "rank_mismatches_off_near_ties": mismatches,
           "rank_mismatches_against_the_cpu_trained_index": cross,
           "max_score_diff_against_the_cpu_trained_index": cross_err,
           "launches": {"train_hash": train_counts, "search_after_train": search_counts},
           "plain_calls": dict(plain.calls)}
    log(f"phase 11a train (code-hash-384): {json.dumps(out)}")
    check(bool(np.isfinite(gpu_l).all()) and loss_rel <= TRAIN_LOSS_RTOL,
          f"train's losses on {device} are not the CPU's: {gpu_l} against {cpu_l}")
    check(touched.any() and equal_share >= TABLE_EQUAL_MIN,
          f"the trained tables agree in {equal_share:.4f} of the touched rows' entries")
    check(mismatches == 0, "the searches after train rank unlike a CPU session's on its index")
    check(chunks_after == {"device": chunks_before, "cpu": chunks_before} and repeated == 0,
          f"train left stale rows: {chunks_before} chunks before, {chunks_after} after, "
          f"{repeated} repeated hits")
    if device == "cuda":
        check(search_counts["fused_cosine_topk"] >= len(TRAIN_QUERIES)
              and search_counts["fused_scores_topk"] > 0,
              f"the searches after train did not launch kernels a and c: {search_counts}")
        check(not plain.calls, f"plain versions ran in the searches: {dict(plain.calls)}")
    return out


def train_cross_encoder_phase(work: Path, device: str) -> dict:
    """11b: ``train --cross-encoder`` (one epoch, the CLI in this process)
    on the same index, then ``search --rerank --json`` through the CLI:
    ``rerank_mode`` ``cross-encoder`` from ``local-cross-encoder``, kernel
    d in the training forwards (one a layer a step, its backward
    recomputed as often) and in the pair forwards, and the reranked hits of
    a GPU session alike a CPU session's off near-ties."""
    import contextlib
    import io

    from codesearch_tpu_torch.cli.main import main as cli
    from codesearch_tpu_torch.search import SearchOptions, SearchSession
    from codesearch_tpu_torch.train.cross_encoder_train import LOCAL_CE_NAME, SMALL_CE_CFG

    db, src = work / "self-db-code-hash-384", str(ROOT / "codesearch_tpu_torch")
    reset_counts()
    t0 = time.perf_counter()
    with PlainCalls() as plain:
        rc = cli(["-q", *_platform(device), "--store", str(db), "train", "--cross-encoder", src,
                  "--epochs", "1"])
        train_counts = route_counts()
    train_s = time.perf_counter() - t0
    train_seq = d_launches_by_seq()
    check(rc == 0, f"train --cross-encoder exited {rc}")
    steps = train_counts["composed_backward"] // SMALL_CE_CFG.layers
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli([*_platform(device), "--store", str(db), "search", TRAIN_QUERIES[0], src,
                  "--rerank", "--json", "--limit", "5"])
    check(rc == 0, f"search --rerank exited {rc}")
    cli_mode = json.loads(printed.getvalue())["rerank_mode"]
    gpu, cpu = SearchSession(db, device=device), SearchSession(db, device="cpu")
    for session in (gpu, cpu):
        _force_device_routes(session)
    reset_counts()
    got = [gpu.search(q, SearchOptions(limit=10, rerank=True)) for q in TRAIN_QUERIES]
    rerank_counts = route_counts()
    want = [cpu.search(q, SearchOptions(limit=11, rerank=True)) for q in TRAIN_QUERIES]
    mismatches = sum(ranked_alike(g.hits, w.hits, RERANK_TOL) for g, w in zip(got, want))
    out = {"train_s": train_s, "steps": steps, "cli_rerank_mode": cli_mode,
           "model": gpu.reranker.model.name, "rank_mismatches_off_near_ties": mismatches,
           "rerank_ms_p50": statistics.median(g.timings_ms["rerank"] for g in got),
           "d_launches_by_seq": {"training": train_seq, "rerank": d_launches_by_seq()},
           "launches": {"train_cross_encoder": train_counts, "rerank_after_train": rerank_counts},
           "plain_calls": dict(plain.calls)}
    log(f"phase 11b train --cross-encoder: {json.dumps(out)}")
    check(cli_mode == "cross-encoder" and gpu.reranker.model.name == LOCAL_CE_NAME
          and all(g.rerank_mode == "cross-encoder" == w.rerank_mode for g, w in zip(got, want)),
          "search --rerank did not run the trained local cross-encoder")
    check(mismatches == 0, "the reranked hits after train --cross-encoder differ from the CPU's")
    if device == "cuda":
        check(steps > 0 and train_counts["attention_full"] == SMALL_CE_CFG.layers * steps
              and train_counts["composed_backward"] == train_counts["attention_full"],
              f"train --cross-encoder: d {train_counts['attention_full']}, recomputes "
              f"{train_counts['composed_backward']} for {steps} steps")
        check(dict(plain.calls) == {"reference_attention": train_counts["composed_backward"]},
              f"plain versions in train --cross-encoder: {dict(plain.calls)}")
        check(rerank_counts["attention_full"] == SMALL_CE_CFG.layers * len(TRAIN_QUERIES),
              f"the reranked searches launched d {rerank_counts['attention_full']} times")
    return out


def d_launches_by_seq() -> dict:
    """Kernel d's launches since the last reset, by sequence length."""
    from codesearch_tpu_torch.ops import attention as att

    return {f"S={s}": c for (k, s), c in sorted(att.launches_by_seq.items())
            if k == "attention_full"}


def _grad_cosines(a, b) -> dict:
    """Cosine of two models' gradients, parameter by parameter."""
    pb = dict(b.named_parameters())
    out = {}
    for name, p in a.named_parameters():
        x, y = p.grad.double().cpu().ravel(), pb[name].grad.double().cpu().ravel()
        out[name] = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
    return out


def contrastive_batches(work: Path) -> tuple:
    """(bge-small's config, CONTRASTIVE_STEPS + 3 batches of the pairs mined
    from phase 4's index, CONTRASTIVE_BATCH at ``max_len`` CONTRASTIVE_LEN):
    11c holds the first to the CPU and times the next CONTRASTIVE_STEPS,
    which phase 14 takes too."""
    import itertools

    from codesearch_tpu_torch.models import parse_model
    from codesearch_tpu_torch.models.tokenizer import load_tokenizer
    from codesearch_tpu_torch.train.data import batches

    cfg = parse_model(BERT_MODEL).arch
    tok = load_tokenizer(None, lowercase=True, max_len=CONTRASTIVE_LEN, vocab_size=cfg.vocab_size)
    pairs = _mined(work / "self-db-code-hash-384", "cpu")
    data = list(itertools.islice(batches(pairs, tok, CONTRASTIVE_BATCH, CONTRASTIVE_LEN, seed=0),
                                 CONTRASTIVE_STEPS + 3))
    check(len(data) == CONTRASTIVE_STEPS + 3, f"only {len(data)} batches of mined pairs")
    return cfg, data


def contrastive_phase(work: Path, device: str) -> dict:
    """11c: InfoNCE steps on bge-small as registered (12 layers, 384, 12
    heads of 32, its init from seed 0), batch 64 of mined pairs at
    ``max_len`` 128. One step held to the same step on the CPU (loss within
    STEP_LOSS_RTOL, gradients at cosine STEP_GRAD_COS_MIN per parameter),
    then CONTRASTIVE_STEPS timed steps: step ms (median), tokens/s, peak
    memory, kernel d 24 times a step (12 layers, queries and documents)
    and as many recomputes in the backward, no other plain version; a
    profiled pair of steps for the device time of d, of the backward
    recomputes and of the optimizer; the first batch's loss lower after the
    steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from codesearch_tpu_torch.train.contrastive import (info_nce_loss, make_train_state,
                                                        make_train_step)

    cfg, data = contrastive_batches(work)
    model, opt = make_train_state(cfg, device=device, seed=0)
    ref_model, ref_opt = make_train_state(cfg, device="cpu", seed=0)
    step, ref_step = make_train_step(cfg, opt), make_train_step(cfg, ref_opt)
    t0 = time.perf_counter()
    loss0 = float(step(model, data[0]))
    t1 = time.perf_counter()
    ref_loss0 = float(ref_step(ref_model, data[0]))
    cpu_step_s = time.perf_counter() - t1
    cos = _grad_cosines(model, ref_model)
    worst = min(cos, key=cos.get)
    del ref_model, ref_opt

    def batch_loss(batch) -> float:
        with torch.no_grad():
            return float(info_nce_loss(model, {k: torch.as_tensor(v).to(model.device)
                                               for k, v in batch.items()}))

    before = batch_loss(data[1])
    _sync(device)
    _peak_reset(device)
    reset_counts()
    times, losses = [], []
    with PlainCalls() as plain:
        for batch in data[1:CONTRASTIVE_STEPS + 1]:
            _sync(device)
            t = time.perf_counter()
            losses.append(float(step(model, batch)))
            times.append((time.perf_counter() - t) * 1000)
        counts = route_counts()
    peak_mb = _peak_mb(device)
    after = batch_loss(data[1])
    tokens = [int(b["query_mask"].sum() + b["doc_mask"].sum())
              for b in data[1:CONTRASTIVE_STEPS + 1]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in data[CONTRASTIVE_STEPS + 1:]:
            step(model, batch)
        _sync(device)
    busy_ms, top = device_kernel_time(prof)
    rows = prof.key_averages()

    def device_ms_of(pred, self_only: bool) -> float:
        return sum((e.self_device_time_total if self_only else e.device_time_total)
                   for e in rows if pred(e.key)) / 1000 / 2

    prof_ms = {"d_forward": device_ms_of(lambda k: "attention_two_sweep" in k, True),
               "backward_recompute": device_ms_of(lambda k: "KernelAttentionBackward" in k
                                                  and "evaluate_function" in k, False),
               "optimizer": device_ms_of(lambda k: k.startswith("Optimizer.step"), False),
               "step_total": busy_ms / 2}
    out = {"model": BERT_MODEL, "batch": CONTRASTIVE_BATCH, "max_len": CONTRASTIVE_LEN,
           "first_step": {"loss": loss0, "cpu_loss": ref_loss0,
                          "loss_rel_err": abs(loss0 - ref_loss0) / abs(ref_loss0),
                          "min_grad_cosine": cos[worst], "min_grad_cosine_param": worst,
                          "card_s": t1 - t0, "cpu_s": cpu_step_s},
           "step_ms_median": statistics.median(times), "step_ms": times,
           "tokens_per_s": sum(tokens) / (sum(times) / 1000),
           "padded_tokens_per_s": len(times) * 2 * CONTRASTIVE_BATCH * CONTRASTIVE_LEN
           / (sum(times) / 1000),
           "peak_mb": peak_mb, "losses": losses, "held_batch_loss": [before, after],
           "profiled_device_ms_a_step": prof_ms, "top_device_ms": top,
           "launches": {"contrastive": counts}, "plain_calls": dict(plain.calls)}
    log(f"phase 11c contrastive steps: {json.dumps(out)}")
    check(out["first_step"]["loss_rel_err"] <= STEP_LOSS_RTOL
          and cos[worst] >= STEP_GRAD_COS_MIN,
          f"the contrastive step on {device} is not the CPU's: loss {loss0} against "
          f"{ref_loss0}, gradient cosine {cos[worst]} at {worst}")
    check(all(map(math.isfinite, losses)) and after < before,
          f"the loss did not fall: {before} -> {after}")
    if device == "cuda":
        n = cfg.layers * 2 * CONTRASTIVE_STEPS
        check(counts["attention_full"] == n and counts["composed_backward"] == n
              and counts["attention_flash"] == 0,
              f"contrastive steps: d {counts['attention_full']}, recomputes "
              f"{counts['composed_backward']} (want {n} each)")
        check(dict(plain.calls) == {"reference_attention": n},
              f"plain versions in the contrastive steps: {dict(plain.calls)}")
        check(prof_ms["d_forward"] > 0, "the profiler saw no time of kernel d")
    return out


def training(work: Path, device: str) -> dict:
    """Phase 11: 11a, 11b and 11c in turn, with their seconds."""
    t0 = time.perf_counter()
    hashed = train_hash_phase(work, device)
    t1 = time.perf_counter()
    ce = train_cross_encoder_phase(work, device)
    t2 = time.perf_counter()
    contrastive = contrastive_phase(work, device)
    t3 = time.perf_counter()
    seconds = {"train": t1 - t0, "train_cross_encoder": t2 - t1, "contrastive": t3 - t2,
               "total": t3 - t0}
    log(f"phase 11 seconds: {seconds}")
    launches = {**hashed.pop("launches"), **ce.pop("launches"), **contrastive.pop("launches")}
    return {"train": hashed, "train_cross_encoder": ce, "contrastive": contrastive,
            "seconds": seconds, "launches": launches}


# ---------------------------------------------------------------------------
# phase 12: the rest of the CLI on the card
# ---------------------------------------------------------------------------

CLI_QUERIES = TRAIN_QUERIES[:4]
CLI_LIMIT = 10
CLI_SCORE_TOL = 2e-4        # the CLI's --json rounds scores to 4 decimals


class KernelInputs:
    """Records the inputs of every call of the top-k wrappers a, b, c while
    active (cloned, unless ``clone`` is False for a window that writes none
    of them afterwards), so each can be held against its plain version at
    the shapes the path gave it. c has two call sites: the BM25 dense leg
    (``ops.bm25``'s binding) and the sharded merge (``ops.fused_topk``'s,
    which ``parallel.sharded_search`` calls); ``c_launches`` counts c's
    launches at each. The recorded calls are the path's own; the checks
    launch again only after the counted window."""

    def __init__(self, clone: bool = True):
        self.clone = clone

    def __enter__(self):
        from codesearch_tpu_torch.ops import bm25
        from codesearch_tpu_torch.ops import fused_topk as ft

        self.calls: list = []
        self.c_launches = {"bm25": 0, "merge": 0}
        sites = [(ft, "fused_cosine_topk", None), (ft, "fused_cosine_topk_int8", None),
                 (bm25, "fused_scores_topk", "bm25"), (ft, "fused_scores_topk", "merge")]
        self._saved = [(mod, name, getattr(mod, name), site) for mod, name, site in sites]
        for mod, name, fn, site in self._saved:
            def recording(*args, _fn=fn, _name=name, _site=site):
                self.calls.append((_name, [a.clone() if self.clone and hasattr(a, "clone")
                                           else a for a in args]))
                before = ft.launch_counts["fused_scores_topk"]
                out = _fn(*args)
                if _site:
                    self.c_launches[_site] += ft.launch_counts["fused_scores_topk"] - before
                return out

            setattr(mod, name, recording)
        return self

    def __exit__(self, *exc):
        for mod, name, fn, _ in self._saved:
            setattr(mod, name, fn)
        return False


def held_by_kernel(held: list) -> dict:
    """``hold_to_plain`` results summed by kernel: calls, shapes, all equal,
    the largest error."""
    by_kernel: dict = {}
    for h in held:
        k = by_kernel.setdefault(h["kernel"], {"calls": 0, "shapes": [], "all_equal": True,
                                               "max_abs_err": 0.0})
        k["calls"] += 1
        k["all_equal"] &= h["equal"]
        k["max_abs_err"] = max(k["max_abs_err"], h["max_abs_err"])
        if [h["shape"], h["k"]] not in k["shapes"]:
            k["shapes"].append([h["shape"], h["k"]])
    return by_kernel


def hold_to_plain(name: str, args: list) -> dict:
    """One recorded call of a, b or c against its plain version on the same
    inputs: b and c bit for bit, a as in phase 3 (SCORE_TOL, no index
    mismatch away from near-ties)."""
    import torch

    from codesearch_tpu_torch.ops import fused_topk as ft

    kernel, plain = getattr(ft, name), getattr(ft, name + "_plain")
    got, ref = kernel(*args), plain(*args)
    out = {"kernel": name, "shape": [list(a.shape) for a in args if hasattr(a, "shape")],
           "k": int(args[3] if name == "fused_scores_topk" else args[-1])}
    if name != "fused_cosine_topk":
        out["equal"] = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        out["max_abs_err"] = float((got[0] - ref[0]).abs().max())
        return out
    q, corpus, valid, k = args
    plain_scores = torch.where(valid[None, :], q.to(torch.bfloat16).float() @ corpus.float().T,
                               ft.NEG_INF)
    if k < corpus.shape[0]:
        ref_next = plain(q, corpus, valid, k + 1)
    else:       # every row taken: nothing past the k-th position
        ref_next = (torch.cat([ref[0], ref[0].new_full((q.shape[0], 1), ft.NEG_INF)], 1),)
    err, row_err, mism = compare_cosine(got, ref, ref_next, plain_scores)
    out.update(max_abs_err=err, max_row_err=row_err, index_mismatches_off_near_ties=mism,
               equal=err <= SCORE_TOL and row_err <= SCORE_TOL and mism == 0)
    return out


def _cli_json(argv: list, device: str):
    """The port's CLI in this process with ``argv`` (``--json`` output):
    (milliseconds, the parsed standard output); it must exit 0."""
    import contextlib
    import io

    from codesearch_tpu_torch.cli.main import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli([*_platform(device), *argv])
    ms = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"`{' '.join(argv)}` exited {rc} on {device}")
    return ms, json.loads(buf.getvalue())


def _json_ranked_alike(got: list, want: list) -> int:
    """ranked_alike over ``--json`` results, a hit named by path and line."""
    def hits(results):
        return [types.SimpleNamespace(chunk_id=(h["path"], h["start_line"]), score=h["score"])
                for h in results]

    return ranked_alike(hits(got), hits(want) + [types.SimpleNamespace(
        chunk_id=None, score=-math.inf)], CLI_SCORE_TOL)


def cli_phase(work: Path, device: str) -> dict:
    """Phase 12: ``stats --json`` over phase 4's indexes (the trained hash
    index, bge-small's and an int8 copy) against ``--platform cpu``;
    ``doctor --json`` and ``doctor --device --json`` on an index of a copy of
    the port's sources; ``search --all-repos --json`` over two registered
    copies (bf16 and int8), every group equal to that repository's own
    ``search``, kernels a, b and c launched (the counts set to 0 just
    before, read just after, no plain version called) and each of their
    calls held against its plain version on the same inputs, the groups
    ranked as the CPU's. The small corpora take the device routes through
    the stores' module knobs, as phase 11a's searches do."""
    import torch

    from codesearch_tpu_torch.cli.main import main as cli
    from codesearch_tpu_torch.fts import store as fts_store
    from codesearch_tpu_torch.vectordb import store as vec_store

    root = work / "cli"
    root.mkdir()
    int8_db = root / "self-db-int8"
    shutil.copytree(work / "self-db-code-hash-384", int8_db)
    set_int8(int8_db, True)
    stats, stats_ms = {}, {}
    for tag, db in (("code-hash-384", work / "self-db-code-hash-384"),
                    ("bge-small", work / f"self-db-{BERT_MODEL}"), ("int8", int8_db)):
        ms, got = _cli_json(["--store", str(db), "stats", "--json"], device)
        cpu_ms, want = _cli_json(["--store", str(db), "stats", "--json"], "cpu")
        check(got == want, f"stats --json of {tag} differs from --platform cpu's: {got} {want}")
        check(got["vector"]["chunks"] == got["fts"]["docs"] > 100,
              f"stats of {tag} counts too few chunks: {got['vector']}")
        stats[tag], stats_ms[tag] = got, {"ms": ms, "cpu_ms": cpu_ms}
    check(2 * stats["int8"]["vector"]["device_bytes"]
          == stats["code-hash-384"]["vector"]["device_bytes"],
          "stats of the int8 copy does not count one byte an entry")

    repos = {}
    ignore = shutil.ignore_patterns("__pycache__")
    for tag, flags in (("bf16", []), ("int8", ["--int8"])):
        repo = root / f"repo-{tag}"
        shutil.copytree(ROOT / "codesearch_tpu_torch", repo, ignore=ignore)
        check(cli(["-q", *_platform(device), "index", str(repo), *flags]) == 0,
              f"index {tag} failed")
        repos[tag] = repo
    for repo in repos.values():
        check(cli(["-q", "index", "add", str(repo)]) == 0, f"index add {repo} failed")

    doctor_ms, checks = _cli_json(["doctor", str(repos["bf16"]), "--json"], device)
    _, cpu_checks = _cli_json(["doctor", str(repos["bf16"]), "--json"], "cpu")
    check(all(c["ok"] for c in checks) and checks == cpu_checks,
          f"doctor on {device}: {checks}; on the CPU: {cpu_checks}")
    device_ms, with_probe = _cli_json(["doctor", str(repos["bf16"]), "--device", "--json"],
                                      device)
    probe = with_probe[-1]
    name = "cpu" if device == "cpu" else torch.cuda.get_device_name(0)
    check(probe["name"] == "device_roundtrip" and probe["ok"]
          and probe["detail"].startswith(f"device={name}, "),
          f"doctor --device's probe: {probe}")
    probe_s = float(probe["detail"].split("round trip ")[1].rstrip("s"))

    cwd = root / "elsewhere"
    cwd.mkdir()
    knobs = [(vec_store, "HOST_PATH_ROWS", 0), (fts_store, "DEVICE_MIN_DOCS", 1),
             (fts_store, "PLANE_DF_FLOOR", 64)]
    saved = [(mod, k, getattr(mod, k)) for mod, k, _ in knobs]
    for mod, k, v in knobs:
        setattr(mod, k, v)
    try:
        own = {tag: [_cli_json(["search", q, str(repo), "--json", "--limit", str(CLI_LIMIT)],
                               device)[1] for q in CLI_QUERIES]
               for tag, repo in repos.items()}
        all_ms = []
        with KernelInputs() as recorded, PlainCalls() as plain:
            reset_counts()
            for q in CLI_QUERIES:
                ms, groups = _cli_json(["search", q, str(cwd), "--all-repos", "--json",
                                        "--limit", str(CLI_LIMIT)], device)
                all_ms.append((ms, groups))
            counts = launch_counts()
            plain_calls = dict(plain.calls)
        cpu = [_cli_json(["search", q, str(cwd), "--all-repos", "--json", "--limit",
                          str(CLI_LIMIT)], "cpu") for q in CLI_QUERIES]
    finally:
        for mod, k, v in saved:
            setattr(mod, k, v)
    dbs = [str(repos[t] / ".codesearch.db") for t in ("bf16", "int8")]
    mismatches = 0
    for qi, (_, groups) in enumerate(all_ms):
        check([g["db_path"] for g in groups] == dbs, f"--all-repos searched {groups}")
        for tag, group in zip(("bf16", "int8"), groups):
            check({k: v for k, v in group.items() if k != "db_path"} == own[tag][qi],
                  f"--all-repos' {tag} group differs from the repository's own search")
            check(len(group["results"]) == CLI_LIMIT, f"--all-repos' {tag} group lacks hits")
        for group, want in zip(groups, cpu[qi][1]):
            mismatches += _json_ranked_alike(group["results"], want["results"])
    held = [hold_to_plain(n, a) for n, a in recorded.calls]
    by_kernel = held_by_kernel(held)
    out = {"stats": stats_ms, "doctor_ms": doctor_ms, "doctor_device_ms": device_ms,
           "probe_s": probe_s, "probe": probe["detail"],
           "all_repos_ms": [ms for ms, _ in all_ms],
           "all_repos_cpu_ms": [ms for ms, _ in cpu],
           "rank_mismatches_off_near_ties": mismatches, "kernels_held_to_plain": by_kernel,
           "plain_calls": plain_calls, "launches": {"all_repos": counts}}
    log(f"phase 12 CLI ({device}): {json.dumps(out)}")
    check(mismatches == 0, "--all-repos ranks unlike the CPU's")
    check(all(h["equal"] for h in held),
          "a kernel of --all-repos disagrees with its plain version")
    if device == "cuda":
        check(not plain_calls, f"plain versions ran in --all-repos: {plain_calls}")
        for kernel in ("fused_cosine_topk", "fused_cosine_topk_int8", "fused_scores_topk"):
            check(counts[kernel] >= len(CLI_QUERIES),
                  f"--all-repos did not launch {kernel}: {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the corpus mesh on the card
# ---------------------------------------------------------------------------

MESH_ROWS = 1 << 20          # 768 MB of bf16 rows, 384 MB of int8
MESH_SHARDS = (2, 4, 8)
MESH_PRODUCT_SHARDS = 4
MESH_DBS = (("code-hash-384", "synthetic-db"), (BERT_MODEL, "bert-synthetic-db"))
MESH_DP_CHUNKS = 256         # dp_encode's batch, at bucket 512


@contextlib.contextmanager
def mesh_installed(mesh):
    """``mesh`` as the port's corpus mesh (its module cache), the cached one
    restored afterwards."""
    from codesearch_tpu_torch.parallel import mesh as tmesh

    saved = tmesh._corpus_mesh, tmesh._corpus_mesh_tried
    tmesh._corpus_mesh, tmesh._corpus_mesh_tried = mesh, True
    try:
        yield mesh
    finally:
        tmesh._corpus_mesh, tmesh._corpus_mesh_tried = saved


class TopkCalls:
    """Counts ``torch.topk`` calls while active: the sharded merge must
    select with kernel c (ties to the lowest index), which ``torch.topk``
    does not promise."""

    def __enter__(self):
        import torch

        self.calls = 0
        self._saved = (torch.topk, torch.Tensor.topk)

        def counted(fn):
            def call(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return call

        torch.topk, torch.Tensor.topk = counted(torch.topk), counted(torch.Tensor.topk)
        return self

    def __exit__(self, *exc):
        import torch

        torch.topk, torch.Tensor.topk = self._saved
        return False


def mesh_direct(device: str, n_rows: int) -> dict:
    """(a) ``sharded_cosine_topk`` and ``_int8`` at ``n_rows`` x DIMS, k=200,
    Q in {1, 9}, over 2, 4 and 8 shards of one device, each held to the
    one-device kernel on the same inputs: indices equal, b's scores bit for
    bit, a's within SCORE_TOL (phase 3's hold; bit equality reported). The
    row at each shard count's first edge (R - 1) is copied to row R, and
    queries 0-2 are those rows: a tie across the edge, which must rank R - 1
    first. Every kernel call of the two (a or b at N and at each shard's R
    rows, the merge's c over the [Q, S * min(k, R)] candidates) is held to
    its plain version on its own inputs (``hold_to_plain``), and the merge
    must launch c once. Each call is timed with CUDA events (median of 20,
    one device, sharded, sharded, one device) and replayed-graph device ms,
    beside the sharded call's bound."""
    import torch

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.ops.topk import quantize_rows_int8
    from codesearch_tpu_torch.parallel import mesh as tmesh
    from codesearch_tpu_torch.parallel import sharded_search as ss

    gen = torch.Generator(device=device).manual_seed(13)
    c = torch.randn(n_rows, DIMS, generator=gen, device=device)
    c = c / c.norm(dim=1, keepdim=True)
    edges = [n_rows // s for s in MESH_SHARDS]
    for r in edges:
        c[r] = c[r - 1]
    q9 = torch.randn(9, DIMS, generator=gen, device=device)
    q9 = q9 / q9.norm(dim=1, keepdim=True)
    q9[:len(edges)] = c[[r - 1 for r in edges]]
    valid = torch.rand(n_rows, generator=gen, device=device) > 0.05
    valid[[r - 1 for r in edges] + edges] = True
    rows = {"fused_cosine_topk": (c.to(torch.bfloat16), valid),
            "fused_cosine_topk_int8": (*quantize_rows_int8(c), valid)}
    del c
    calls = {"fused_cosine_topk": ss.sharded_cosine_topk,
             "fused_cosine_topk_int8": ss.sharded_cosine_topk_int8}
    n_valid = int(valid.sum())
    out: dict = {}
    for name, sharded_fn in calls.items():
        int8 = name.endswith("int8")
        args = rows[name]
        for s in MESH_SHARDS:
            mesh = tmesh.make_mesh(n_data=s, devices=[torch.device(device)] * s)
            placed = [ss.ShardedTensor.place(t, mesh) for t in args]
            r = n_rows // s
            for q in (q9[:1], q9):
                nq = q.shape[0]
                with KernelInputs(clone=False) as rec:
                    one = getattr(ft, name)(q, *args, 200)
                    got = sharded_fn(q, *placed, 200)
                # every kernel call of the two: the one-device call at n_rows,
                # one a shard at R rows, the merge's c over [Q, S * min(200, R)]
                held = [hold_to_plain(n, a) for n, a in rec.calls]
                check([(n, list(a[0].shape) if n == "fused_scores_topk" else [a[1].shape[0]])
                       for n, a in rec.calls]
                      == [(name, [n_rows])] + [(name, [r])] * s
                      + [("fused_scores_topk", [nq, s * min(200, r)])],
                      f"sharded {name} over {s} shards made other kernel calls: "
                      f"{[(n, [list(x.shape) for x in a if hasattr(x, 'shape')]) for n, a in rec.calls]}")
                check(all(h["equal"] for h in held),
                      f"a kernel call of sharded {name} over {s} shards (Q={nq}) disagrees with "
                      f"its plain version: {held_by_kernel(held)}")
                if device == "cuda":
                    check(rec.c_launches["merge"] == 1,
                          f"the merge of {s} shards launched c {rec.c_launches['merge']} times")
                err = float((got[0] - one[0]).abs().max())
                bits = torch.equal(got[0], one[0])
                check(torch.equal(got[1], one[1]),
                      f"sharded {name} over {s} shards ranks other rows than one device (Q={nq})")
                check(bits if int8 else err <= SCORE_TOL,
                      f"sharded {name} over {s} shards: scores off by {err} (Q={nq})")
                tie = MESH_SHARDS.index(s)
                if tie < nq:
                    check(got[1][tie, :2].tolist() == [r - 1, r],
                          f"the tie across the edge of {s} shards ranks {got[1][tie, :2].tolist()}")
                row = {"max_abs_err": err, "bit_equal": bits,
                       "held_to_plain": held_by_kernel(held)}
                if device == "cuda":
                    one_call = lambda q=q: getattr(ft, name)(q, *args, 200)  # noqa: E731
                    sh_call = lambda q=q: sharded_fn(q, *placed, 200)  # noqa: E731
                    t_one_1, t_sh_1 = cuda_ms(one_call), cuda_ms(sh_call)
                    t_sh_2, t_one_2 = cuda_ms(sh_call), cuda_ms(one_call)
                    kk = min(200, r)
                    row.update(
                        ms=min(t_sh_1, t_sh_2), one_device_ms=min(t_one_1, t_one_2),
                        device_ms=device_ms(sh_call), one_device_device_ms=device_ms(one_call),
                        **bound(n_valid * (DIMS + 4 if int8 else 2 * DIMS) + n_rows
                                + nq * DIMS * 4 + 2 * s * nq * kk * 8 + nq * 200 * 8,
                                2 * nq * n_valid * DIMS, "int8" if int8 else "bf16"))
                out.setdefault(name, {})[f"S={s} Q={nq}"] = row
                log(f"phase 13 direct {name} N={n_rows} S={s} Q={nq} k=200: {json.dumps(row)}")
        del placed
    return out


def mesh_queries(session, device: str) -> dict:
    """Ranked (chunk id, score) lists and wall ms of phase 5's hybrid, vector
    and identifier queries, then of one WAVE_QUERIES wave (64) through
    ``search_many``."""
    from codesearch_tpu_torch.search import SearchOptions

    out: dict = {"hits": [], "ms": {}}
    for qtype, qs in (("hybrid", HYBRID_QUERIES[:4]), ("vector", VECTOR_QUERIES[:2]),
                      ("identifier", IDENT_QUERIES[:2])):
        for q in qs:
            _sync(device)
            t = time.perf_counter()
            resp = session.search(q, SearchOptions(limit=10, mode="vector" if qtype == "vector"
                                                   else "hybrid"))
            out["ms"].setdefault(qtype, []).append((time.perf_counter() - t) * 1000)
            check(resp.hits, f"no hits for {q!r}")
            out["hits"].append([(h.chunk_id, h.score) for h in resp.hits])
    _sync(device)
    t = time.perf_counter()
    wave = session.search_many(WAVE_QUERIES, SearchOptions(limit=SERVE_LIMIT))
    out["wave_ms"] = (time.perf_counter() - t) * 1000
    out["wave"] = [[(h.chunk_id, h.score) for h in r.hits] for r in wave]
    out["p50_ms"] = {k: statistics.median(v) for k, v in out["ms"].items()}
    return out


def mesh_sessions(work: Path, device: str, mesh) -> dict:
    """``mesh_queries`` of phase 5's and phase 7's indexes, bf16 and int8,
    each through a new session (sharded when ``mesh`` is installed)."""
    import torch

    from codesearch_tpu_torch.parallel.sharded_search import ShardedTensor

    out = {}
    for model, name in MESH_DBS:
        for int8 in (False, True):
            set_int8(work / name, int8)
            opened = open_session(work / name, device)
            session = opened.pop("session")
            kind, mat = session.store._device[0], session.store._device[1]
            check(kind == ("int8" if int8 else "bf16"), f"{name} opened as {kind}")
            if mesh is not None:
                check(isinstance(mat, ShardedTensor) and len(mat.shards) == mesh.shape["data"]
                      and session.fts._resident_device() == mesh.lead,
                      f"the {name} session is not on the mesh")
            else:
                check(isinstance(mat, torch.Tensor), f"the {name} session is sharded")
            out[(model, int8)] = {**mesh_queries(session, device), **opened}
            del session, mat
            if device == "cuda":
                torch.cuda.empty_cache()
    return out


def mesh_phase(work: Path, device: str, self_index: dict, n_rows: int = MESH_ROWS) -> dict:
    """Phase 13: (a) ``mesh_direct``; (b) phase 5's and 7's indexes through
    sessions on a mesh of MESH_PRODUCT_SHARDS shards of the card, ranked as
    one-device sessions bit for bit; (c) ``dp_embed_features`` over the
    port's sources' chunks against ``embed_features`` (1e-5), ``dp_encode`` of
    bge-small on MESH_DP_CHUNKS chunks at bucket 512 against one-device
    ``encode`` (cosine >= EMBED_COS_MIN, the same top-10 neighbours off
    near-ties) and an ``index`` of the port's sources on the mesh (phase 4's
    chunk count and CLI hits). The one-device references run first; then the
    counts go to 0 and (b) and (c) run on the mesh as the path "sharded":
    a or b once a shard a query, c once a query for the merge (counted
    apart from the BM25 legs' c), d 12 x 4 a ``dp_encode`` batch; no plain
    version and no ``torch.topk``. After the window every a, b and c call
    of (b) and (c) is held to its plain version on its own inputs."""
    import numpy as np
    import torch

    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.embed import service as esvc
    from codesearch_tpu_torch.index import IndexOptions, index
    from codesearch_tpu_torch.models.hash_embedder import batch_features, embed_features
    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.parallel import mesh as tmesh
    from codesearch_tpu_torch.parallel.dp_embed import dp_embed_features, dp_encode
    from codesearch_tpu_torch.search import SearchOptions, SearchSession
    from codesearch_tpu_torch.utils.constants import get_embedding_cache_dir
    from codesearch_tpu_torch.vectordb import VectorStore

    t0 = time.perf_counter()
    _peak_reset(device)
    out: dict = {"direct": mesh_direct(device, n_rows)}
    _sync(device)
    out["direct_s"] = time.perf_counter() - t0

    # one-device references
    ref = mesh_sessions(work, device, None)
    texts = [m.content for _, m in VectorStore(work / "self-db-code-hash-384", dims=DIMS,
                                               readonly=True, device="cpu").iter_chunks()]
    feats = [batch_features(texts[a:a + 1024]) for a in range(0, len(texts), 1024)]
    table = EmbeddingService("code-hash-384", use_persistent_cache=False,
                             device=device).backend.model.table
    dev = torch.device(device)
    single = torch.cat([embed_features(table, torch.from_numpy(i).to(dev),
                                       torch.from_numpy(w).to(dev)) for i, w in feats]).cpu()
    encoder = EmbeddingService(BERT_MODEL, use_persistent_cache=False,
                               device=device).backend.encoder
    gen = torch.Generator().manual_seed(13)
    ids = torch.randint(1000, encoder.cfg.vocab_size, (MESH_DP_CHUNKS, 512), generator=gen)
    lens = torch.randint(257, 513, (MESH_DP_CHUNKS,), generator=gen)
    mask = (torch.arange(512)[None, :] < lens[:, None]).to(torch.int32)
    ids, mask = ids.int().numpy(), mask.numpy()
    one_enc = encoder.encode(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)).cpu()
    shutil.rmtree(get_embedding_cache_dir("code-hash-384-torch"), ignore_errors=True)

    mesh = tmesh.make_mesh(n_data=MESH_PRODUCT_SHARDS, devices=[dev] * MESH_PRODUCT_SHARDS)
    dp_calls = []
    real_dp = esvc.embed_feature_shards
    esvc.embed_feature_shards = lambda *a, **kw: dp_calls.append(1) or real_dp(*a, **kw)
    try:
        # the window writes no recorded input after its call (the sessions
        # only read; ``index`` writes its store before its one search), so
        # the inputs are held by reference, not cloned
        with PlainCalls() as plain, TopkCalls() as topk, mesh_installed(mesh), \
                KernelInputs(clone=False) as recorded:
            reset_counts()
            sharded = mesh_sessions(work, device, mesh)
            dp = np.concatenate([dp_embed_features(table, i, w, mesh) for i, w in feats])
            d0 = att.launch_counts["attention_full"]
            dp_enc = torch.from_numpy(dp_encode(encoder, ids, mask, mesh))
            d_dp = att.launch_counts["attention_full"] - d0
            t = time.perf_counter()
            stats = index(ROOT / "codesearch_tpu_torch",
                          IndexOptions(store_path=work / "mesh-self-db", quiet=True),
                          device=device)
            index_s = time.perf_counter() - t
            session = SearchSession(work / "mesh-self-db", device=device)
            self_hits = [(h.path, h.start_line + 1, round(h.score, 4)) for h in
                         session.search(SELF_QUERY, SearchOptions(limit=5)).hits]
            out["launches"] = {"sharded": launch_counts()}
    finally:
        esvc.embed_feature_shards = real_dp
    # every a, b and c call of the window against its plain version
    held = [hold_to_plain(n, a) for n, a in recorded.calls]
    out["held_to_plain"] = held_by_kernel(held)
    out["c_launches_by_site"] = dict(recorded.c_launches)
    del recorded
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["peak_mb"] = _peak_mb(device)

    counts = out["launches"]["sharded"]
    log(f"phase 13 launches on the path 'sharded': {counts}; c by site "
        f"{out['c_launches_by_site']}; plain versions called {dict(plain.calls)}; torch.topk "
        f"calls {topk.calls}")
    log(f"phase 13 kernel calls held to their plain versions: {json.dumps(out['held_to_plain'])}")
    check(topk.calls == 0, f"torch.topk ran on the mesh path ({topk.calls} calls)")
    check(all(h["equal"] for h in held),
          "a kernel call of the mesh path disagrees with its plain version")
    for (model, int8), got in sharded.items():
        want = ref[(model, int8)]
        tag = f"{model} {'int8' if int8 else 'bf16'}"
        same = got["hits"] == want["hits"] and got["wave"] == want["wave"]
        log(f"phase 13 {tag}: sharded p50 ms {got['p50_ms']} (one device {want['p50_ms']}); "
            f"64-query wave {got['wave_ms']:.2f} ms (one device {want['wave_ms']:.2f}); open "
            f"{got['open_s']:.2f} s + first query {got['first_query_s']:.2f} s; the same ranked "
            f"hits, scores bit for bit: {same}")
        check(same, f"the sharded {tag} session ranks other hits than one device")
        out[f"{tag} p50_ms"] = {"sharded": got["p50_ms"], "one_device": want["p50_ms"],
                                "wave_sharded": got["wave_ms"], "wave_one_device": want["wave_ms"]}
    if device == "cuda":   # the launch gates (the CPU runs the plain versions)
        # every session call (the probe, the queries, the wave) is one
        # sharded top-k: a or b once a shard, c once for the merge
        n_bf16 = sum(len(v["hits"]) + 2 for (_, i8), v in sharded.items() if not i8)
        n_int8 = sum(len(v["hits"]) + 2 for (_, i8), v in sharded.items() if i8)
        s = MESH_PRODUCT_SHARDS
        check(not plain.calls, f"plain versions ran on the mesh path: {dict(plain.calls)}")
        check(counts["fused_cosine_topk"] >= s * n_bf16
              and counts["fused_cosine_topk_int8"] >= s * n_int8,
              f"a or b launched fewer than {s} times a query: {counts}")
        merges = out["c_launches_by_site"]["merge"]
        check(merges >= n_bf16 + n_int8, f"the merge launched c {merges} times, fewer than "
              f"once a query ({n_bf16 + n_int8})")
        check(counts["fused_cosine_topk"] + counts["fused_cosine_topk_int8"] == s * merges,
              f"a and b launched other than {s} times a merge: {counts}, {merges} merges")
        check(d_dp == BERT_LAYERS * s, f"dp_encode launched attention_full {d_dp} times, "
              f"not {BERT_LAYERS} x {s}")

    dp_err = float(np.abs(dp - single.numpy()).max())
    cos = torch.nn.functional.cosine_similarity(dp_enc.double(), one_enc.double(), dim=1)
    # the top-10 neighbours of each chunk among the one-device embeddings, by
    # its dp and by its one-device embedding, equal off near-ties: two
    # neighbours closer than the largest score difference the two
    # embeddings make may swap
    ref_scores = one_enc.double() @ one_enc.double().T
    dp_scores = dp_enc.double() @ one_enc.double().T
    tol = float((dp_scores - ref_scores).abs().max())
    rv, ri = torch.sort(ref_scores, dim=1, descending=True, stable=True)
    dv, di = torch.sort(dp_scores, dim=1, descending=True, stable=True)
    gap = (rv[:, :10] - rv[:, 1:11]).abs() > 2 * tol
    clear = gap.clone()
    clear[:, 1:] &= gap[:, :-1]
    nb_mism = int(((di[:, :10] != ri[:, :10]) & clear).sum())
    out["dp"] = {"embed_features_max_abs_err": dp_err, "texts": len(texts),
                 "embed_feature_shards_calls_while_indexing": len(dp_calls),
                 "dp_encode_min_cosine": float(cos.min()), "dp_encode_bit_equal":
                 torch.equal(dp_enc, one_enc), "neighbour_score_tol": tol,
                 "neighbour_mismatches_off_near_ties": nb_mism,
                 "attention_full_per_dp_encode": d_dp, "index_s": index_s,
                 "index_chunks": stats.chunks_added, "phase4_chunks": self_index["chunks"]}
    log(f"phase 13 data-parallel embedding: {json.dumps(out['dp'])}")
    log(f"phase 13 index on the mesh: hits {self_hits}; phase 4's CLI {self_index['hits']}")
    check(dp_err <= 1e-5, f"dp_embed_features is off embed_features by {dp_err}")
    check(float(cos.min()) >= EMBED_COS_MIN and nb_mism == 0,
          "dp_encode disagrees with the one-device encode")
    check(len(dp_calls) > 0, "indexing on the mesh never sharded its embed batches")
    check(stats.chunks_added == self_index["chunks"] and self_hits == [tuple(h) for h in
                                                                       self_index["hits"]],
          "the index on the mesh differs from phase 4's")
    log(f"phase 13 seconds: {out['seconds']:.2f} (direct {out['direct_s']:.2f}); peak MB "
        f"{out['peak_mb']}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the training mesh on the card
# ---------------------------------------------------------------------------

TRAIN_MESH = (2, 2)             # (n_data, n_model) of (b): four ranks on the one card
TRAIN_MESH_TIMEOUT_S = 300
ADAM_BOUND = 2 * CONTRASTIVE_STEPS * 1e-4   # 2 x steps x lr: the parameters' drift
# (b) against the one-device step, beyond its first loss and cosines; the
# witness (the one-device steps with d's plain forward) comes as far, and
# an averaged gradient would be 0.5 off (H100 80GB HBM3, 700.00 W: (b),
# witness measured)
MESH_LOSS_RTOL = 5e-2           # every step's loss: 2.8e-3, 4.0e-3 (1.8e-2 in one run of (b))
MESH_GRAD_NORM_RTOL = 3e-2      # each first-step gradient's norm: 1.1e-2, 8.0e-3
MESH_GRAD_REL_MAX = 0.15        # its relative L2 error: 0.091, 0.080 (the position table)
MESH_UPDATE_REL_MAX = 0.5       # each parameter's update over the steps, k_b apart: 0.20, 0.19


def _jax_side() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "codesearch_tpu"))


def _fused_grads(cfg, tree: dict) -> dict:
    """A JAX-layout tree as f32 CPU tensors under the port's parameter names
    (a BERT layer's q, k and v fused, as the one-device model holds them)."""
    from codesearch_tpu_torch.models.encoder import BertEncoder

    return {name: p.detach() for name, p in
            BertEncoder(cfg, tree, device="cpu", trainable=True).named_parameters()}


def held_to_one_device(ref: dict, losses: list, grads: dict, params: dict) -> dict:
    """A run's distance from the one-device steps ``ref`` (its ``losses``,
    first-step ``grads`` under the port's names, JAX-layout ``params`` and
    ``init``): every step's relative loss error; per first-step gradient
    the cosine, the relative L2 error and how far the norm ratio is from 1;
    the parameters' largest difference; per parameter the relative L2
    error of the update over the steps (``k_b`` apart: its gradient is zero
    but for rounding, a bias on every key leaving the softmax as it is)."""
    import numpy as np

    def worst(values: dict, key=max) -> list:
        name = key(values, key=values.get)
        return [values[name], name]

    cos, rel, norm, upd = {}, {}, {}, {}
    for name, g in ref["grads"].items():
        x = grads[name].double().cpu().ravel()
        y = g.double().cpu().ravel()
        cos[name] = float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))
        rel[name] = float((x - y).norm() / y.norm().clamp(min=1e-300))
        norm[name] = abs(float(x.norm() / y.norm().clamp(min=1e-300)) - 1)
    diff = 0.0
    for name, want in ref["params"].items():
        diff = max(diff, float(np.abs(params[name] - want).max()))
        if not name.endswith("k_b"):
            d_got = (params[name] - ref["init"][name]).astype(np.float64)
            d_want = (want - ref["init"][name]).astype(np.float64)
            upd[name] = float(np.linalg.norm(d_got - d_want) / max(np.linalg.norm(d_want), 1e-300))
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    return {"losses": losses, "loss_rel_errs": loss_err, "loss_max_rel_err": max(loss_err),
            "first_loss_rel_err": loss_err[0], "min_grad_cosine": worst(cos, min),
            "max_grad_rel_err": worst(rel), "max_grad_norm_off": worst(norm),
            "max_param_diff": diff, "max_update_rel_err": worst(upd)}


def train_mesh_rank(mesh, cfg, data: list) -> dict:
    """One rank of phase 14 (b), in a process ``spawn_ranks`` started:
    ``train_runs`` (the first step's gradients gathered) with the launches
    and plain-version calls counted, kernel d's first call recorded and the
    all_reduces timed (host clock, the device synchronised before each);
    after the counted window d's call is held to its plain version. Returns
    the run, its counts, the step ms, the steps' all_reduces (calls, ms,
    MB; not the gathers between steps), the peak MB, the check of d, the
    modules of the JAX side this process imported and (rank 0) d's recorded
    inputs."""
    import torch
    import torch.distributed as dist

    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.parallel.launch import train_runs
    from codesearch_tpu_torch.train import contrastive

    kernel, recorded, device = att.attention_full, [], mesh.device.type
    all_reduce, reduces, in_step = dist.all_reduce, [], []
    make_step = contrastive.make_train_step

    def marked_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def marked(model, batch):
            in_step.append(True)
            try:
                return step(model, batch)
            finally:
                in_step.pop()

        return marked

    def recording(q, k, v, mask):
        if not recorded:
            recorded.append([t.detach().clone() for t in (q, k, v, mask)])
        return kernel(q, k, v, mask)

    def timed_all_reduce(t, *args, **kwargs):
        if not in_step:
            return all_reduce(t, *args, **kwargs)
        _sync(device)
        t0 = time.perf_counter()
        out = all_reduce(t, *args, **kwargs)
        reduces.append(((time.perf_counter() - t0) * 1000, t.numel() * t.element_size()))
        return out

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    _peak_reset(device)
    att.attention_full, dist.all_reduce = recording, timed_all_reduce
    contrastive.make_train_step = marked_make_step
    try:
        with PlainCalls() as plain:
            out = train_runs(mesh, [{"cfg": cfg, "batches": data}])[0]
            counts = route_counts()
    finally:
        att.attention_full, dist.all_reduce = kernel, all_reduce
        contrastive.make_train_step = make_step
    out["peak_mb"] = _peak_mb(device)
    q, k, v, mask = recorded[0]
    got = att.attention_full(q, k, v, mask)
    ref = att.attention_full_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    err, share, ok = compare_attention(got, ref)
    out.update(rank=mesh.rank, launches=counts, plain_calls=dict(plain.calls),
               all_reduces={"calls_a_step": len(reduces) / len(data),
                            "ms_a_step": sum(ms for ms, _ in reduces) / len(data),
                            "mb_a_step": sum(b for _, b in reduces) / 2**20 / len(data)},
               d_check={"shape": list(q.shape), "max_abs_err": err, "share_differing": share,
                        "ok": ok and bool(torch.isfinite(got).all())},
               jax_side=_jax_side(),
               d_inputs=[t.cpu() for t in recorded[0]] if mesh.rank == 0 else None)
    return out


def mesh_d_row(inputs: list, launches: int, device: str) -> dict:
    """Kernel d at the mesh's local-head shape (rank 0's first call of (b)),
    in this process: held to its plain version, events ms (plain-kernel-
    kernel-plain), device ms, bound and SDPA's time, as phase 3's rows."""
    import torch

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms
    from codesearch_tpu_torch.ops import attention as att

    q, k, v, mask = (t.to(device) for t in inputs)
    kern, plain = att.attention_full, att.attention_full_plain
    err, _, ok = compare_attention(kern(q, k, v, mask), plain(q, k, v, mask))
    check(ok, "kernel d disagrees with its plain version at the mesh's local-head shape")
    if device != "cuda":
        return {"launches": launches, "ms": "not measured"}
    t_plain_1 = cuda_ms(lambda: plain(q, k, v, mask), reps=10)
    t_kern_1 = cuda_ms(lambda: kern(q, k, v, mask), reps=10)
    t_kern_2 = cuda_ms(lambda: kern(q, k, v, mask), reps=10)
    t_plain_2 = cuda_ms(lambda: plain(q, k, v, mask), reps=10)
    row = {"shape": f"B={q.shape[0]} H={q.shape[1]} S={q.shape[2]} Dh={q.shape[3]} "
                    "(the local heads of a 2 x 2 mesh, bge-small, under autograd)",
           "launches": launches, "ms": min(t_kern_1, t_kern_2),
           "events_ms": [t_kern_1, t_kern_2], "plain_ms": min(t_plain_1, t_plain_2),
           "device_ms": device_ms(lambda: kern(q, k, v, mask)), **attention_bound(q, mask),
           "library_ms": sdpa_ms(q, k, v, mask),
           "library_device_ms": device_ms(sdpa_call(q, k, v, mask)), "max_abs_err": err}
    torch.cuda.synchronize()
    return row


def train_mesh_phase(work: Path, device: str, contrastive: dict) -> dict:
    """Phase 14: contrastive steps of bge-small as registered on a training
    mesh, over phase 11c's CONTRASTIVE_STEPS timed batches. First the
    one-device ``make_train_step`` on the card (the reference) and a witness
    (the same steps with d's plain version forward: how far a last-bit
    difference carries over the steps, logged beside (b)), then (a) a 1 x 1
    mesh over NCCL in this process (``file://`` store, the group destroyed
    after): losses and parameters bit for bit the one-device step's; (b) a
    TRAIN_MESH mesh of four ranks on the one card over gloo (``spawn_ranks``;
    NCCL refuses two ranks on one GPU), held to the one-device step
    (``held_to_one_device``): rank 0's first loss within STEP_LOSS_RTOL and
    every loss within MESH_LOSS_RTOL, each first-step gathered gradient at
    cosine STEP_GRAD_COS_MIN, its norm within MESH_GRAD_NORM_RTOL and its
    relative L2 error within MESH_GRAD_REL_MAX, the gathered parameters
    after the steps within the Adam bound and each parameter's update
    within MESH_UPDATE_REL_MAX; on every
    rank d 24 times a step (12 layers, queries and documents, at H=6) and
    as many recomputes, no other plain version, its first d call equal to
    its plain version, nothing of the JAX side imported. Kernel d's
    launches of (a) and (b) are the path "train_mesh"; d is timed at the
    local-head shape. Four ranks share one card and gloo goes through the
    host: the step ms are no scaling figure."""
    import numpy as np

    from codesearch_tpu_torch.models.encoder import cached_init_params, flatten_params
    from codesearch_tpu_torch.ops import attention as att
    from codesearch_tpu_torch.parallel.launch import spawn_ranks
    from codesearch_tpu_torch.parallel.train_mesh import init_train_mesh
    from codesearch_tpu_torch.train.contrastive import (make_sharded_train_state,
                                                        make_train_state, make_train_step)

    t0 = time.perf_counter()
    cfg, data = contrastive_batches(work)
    data = data[1:CONTRASTIVE_STEPS + 1]
    n = cfg.layers * 2 * CONTRASTIVE_STEPS

    def timed_steps(model, step) -> tuple[list, list, dict | None]:
        losses, times, grads = [], [], None
        for batch in data:
            _sync(device)
            t = time.perf_counter()
            losses.append(float(step(model, batch)))
            times.append((time.perf_counter() - t) * 1000)
            if grads is None:
                grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()}
        return losses, times, grads

    def one_device() -> tuple[dict, list]:
        model, opt = make_train_state(cfg, device=device, seed=0)
        losses, times, grads = timed_steps(model, make_train_step(cfg, opt))
        return {"losses": losses, "grads": grads,
                "params": flatten_params(model.to_params())}, times

    ref, ref_ms = one_device()
    ref["init"] = flatten_params(cached_init_params(cfg, 0))
    # the witness: the one-device steps again with kernel d's forward taken
    # by its plain version (the same function, rounded apart in a few last
    # bits), to show how far such a difference carries over the steps
    kernel = att.attention_full
    att.attention_full = att.attention_full_plain
    try:
        wit, _ = one_device()
    finally:
        att.attention_full = kernel
    witness = held_to_one_device(ref, wit["losses"], wit["grads"], wit["params"])
    del wit
    log(f"phase 14 witness (one device, d's plain version forward): {json.dumps(witness)}")

    # (a) 1 x 1 over NCCL in this process
    # (a CPU rehearsal takes gloo: NCCL runs on CUDA only)
    mesh = init_train_mesh(1, 1, backend="nccl" if device == "cuda" else "gloo",
                           init_method=f"file://{work / 'nccl-store'}", rank=0, world_size=1,
                           device=device)
    try:
        reset_counts()
        with PlainCalls() as plain:
            model, opt = make_sharded_train_state(cfg, mesh, seed=0)
            losses, times, _ = timed_steps(model, make_train_step(cfg, opt, mesh))
            counts_a = route_counts()
        params = flatten_params(model.gather_params())
    finally:
        mesh.destroy()
    del model, opt
    param_diff = max(float(np.abs(params[k] - ref["params"][k]).max()) for k in ref["params"])
    one = {"losses": losses, "one_device_losses": ref["losses"],
           "bit_equal": losses == ref["losses"] and param_diff == 0.0,
           "max_param_diff": param_diff, "step_ms_median": statistics.median(times),
           "one_device_step_ms_median": statistics.median(ref_ms),
           "phase_11c_step_ms_median": contrastive["step_ms_median"],
           "launches": counts_a, "plain_calls": dict(plain.calls)}
    log(f"phase 14 (a) 1 x 1 over NCCL: {json.dumps(one)}")

    # (b) 2 x 2 over gloo: four ranks on the one card (both parts run before
    # either is checked)
    t1 = time.perf_counter()
    ranks = spawn_ranks(*TRAIN_MESH, train_mesh_rank, (cfg, data), backend="gloo",
                        device=device, init_dir=work / "train-mesh-init",
                        timeout=TRAIN_MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t1
    r0 = ranks[0]
    held = held_to_one_device(ref, r0["losses"], _fused_grads(cfg, r0["grads"]),
                              flatten_params(r0["params"]))
    d_row = mesh_d_row(r0["d_inputs"], sum(r["launches"]["attention_full"] for r in ranks),
                       device)
    two = {"grid": list(TRAIN_MESH), "backend": "gloo", **held, "adam_bound": ADAM_BOUND,
           "witness": witness, "spawn_and_run_s": spawn_s,
           "ranks": [{"rank": r["rank"], "step_ms_median": statistics.median(r["step_ms"]),
                      "step_ms": r["step_ms"], "peak_mb": r["peak_mb"],
                      "all_reduces": r["all_reduces"],
                      "attention_full": r["launches"]["attention_full"],
                      "composed_backward": r["launches"]["composed_backward"],
                      "plain_calls": r["plain_calls"], "d_check": r["d_check"],
                      "jax_side": r["jax_side"]} for r in ranks],
           "d_local_heads": d_row}
    log(f"phase 14 (b) {TRAIN_MESH[0]} x {TRAIN_MESH[1]} over gloo on one card: "
        f"{json.dumps(two)}")
    # on the CPU the one-device step itself is not bit-reproducible (the
    # word table's gradient accumulates over threads), so a rehearsal
    # holds (a) to the tolerances of (b) only
    check(max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])) <= STEP_LOSS_RTOL
          and param_diff <= ADAM_BOUND and (device != "cuda" or one["bit_equal"]),
          f"the 1 x 1 mesh is not the one-device step: losses {losses} against "
          f"{ref['losses']}, parameters {param_diff} apart")
    check(device != "cuda" or (counts_a["attention_full"] == n
                               and counts_a["composed_backward"] == n
                               and one["plain_calls"] == {"reference_attention": n}),
          f"(a): d {counts_a['attention_full']}, recomputes {counts_a['composed_backward']}, "
          f"plain {one['plain_calls']} (want {n} each)")
    check(all(r["losses"] == r0["losses"] for r in ranks), "the ranks' losses differ")
    check(held["first_loss_rel_err"] <= STEP_LOSS_RTOL
          and held["loss_max_rel_err"] <= MESH_LOSS_RTOL
          and held["min_grad_cosine"][0] >= STEP_GRAD_COS_MIN
          and held["max_grad_norm_off"][0] <= MESH_GRAD_NORM_RTOL
          and held["max_grad_rel_err"][0] <= MESH_GRAD_REL_MAX,
          f"the 2 x 2 step is not the one-device step: losses {held['loss_rel_errs']} off "
          f"(first within {STEP_LOSS_RTOL}, all within {MESH_LOSS_RTOL}), first-step "
          f"gradients at cosine {held['min_grad_cosine']}, norms {held['max_grad_norm_off']} "
          f"off, relative error {held['max_grad_rel_err']}")
    check(held["max_param_diff"] <= ADAM_BOUND
          and held["max_update_rel_err"][0] <= MESH_UPDATE_REL_MAX,
          f"the 2 x 2 parameters drifted {held['max_param_diff']} from the one-device "
          f"step's (bound {ADAM_BOUND}), updates {held['max_update_rel_err']} apart "
          f"(bound {MESH_UPDATE_REL_MAX})")
    for r in ranks:
        c = r["launches"]
        check(device != "cuda" or (c["attention_full"] == n and c["composed_backward"] == n
                                   and c["attention_flash"] == 0
                                   and r["plain_calls"] == {"reference_attention": n}),
              f"rank {r['rank']}: d {c['attention_full']}, recomputes {c['composed_backward']}, "
              f"plain {r['plain_calls']} (want {n} each)")
        check(r["d_check"]["ok"] and r["d_check"]["shape"] == [
            CONTRASTIVE_BATCH // TRAIN_MESH[0], cfg.heads // TRAIN_MESH[1], CONTRASTIVE_LEN,
            cfg.hidden // cfg.heads], f"rank {r['rank']}: kernel d's check {r['d_check']}")
        check(not r["jax_side"], f"rank {r['rank']} imported {r['jax_side'][:5]}")
    counts = collections.Counter(counts_a)
    for r in ranks:
        counts.update(r["launches"])
    out = {"one_by_one": one, "two_by_two": two, "seconds": time.perf_counter() - t0,
           "launches": {"train_mesh": dict(counts)}}
    log(f"phase 14 seconds: {out['seconds']:.2f} (the four ranks {spawn_s:.2f})")
    return out


def nvidia_smi_line() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, stdin=subprocess.DEVNULL)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}")
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "codesearch_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: codesearch_tpu_torch is missing beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    os.environ["CODESEARCH_HOME"] = str(work / "home")
    try:
        smi = nvidia_smi_line()
        log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"card: {smi}")
        from codesearch_tpu_torch import native
        from codesearch_tpu_torch.ops import _build
        from codesearch_tpu_torch.ops import fused_topk as ft

        try:
            import msgpack  # noqa: F401
            has_msgpack = True
        except ImportError:
            has_msgpack = False
        log(f"msgpack importable: {has_msgpack}; native host tier (g++) loaded: "
            f"{native.is_available()}")
        t = time.perf_counter()
        _build.load(verbose=True)
        log(f"kernel build + load {time.perf_counter() - t:.2f} s "
            f"(nvcc {_build.build_log['seconds']:.2f} s) -> {_build.build_log['path']}")
        for line in _build.build_log["output"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  " + line.strip())
        timing = kernel_checks("cuda")
        timing.update(attention_checks("cuda"))
        grads = attention_grad_checks("cuda")
        self_index = repo_index_and_cli(work, "cuda")
        synthetic_session(work, N_ROWS, "cuda", cpu_check=True)
        from codesearch_tpu_torch.ops import attention as att

        att.reset_launch_counts()
        repo_index_and_cli(work, "cuda", model=BERT_MODEL)
        log(f"{BERT_MODEL} index of codesearch_tpu_torch/: attention launches by (kernel, S) "
            f"{dict(att.launches_by_seq)}")
        bert = bert_synthetic(work, N_ROWS, "cuda")
        timing.update(packed_checks("cuda"))
        ablation = packed_ablation(work)
        served = serving(work, "cuda")
        family = encoder_family(work, "cuda")
        log(f"phase 10 results ({smi}): {json.dumps(family, default=str)}")
        loads = checkpoint_phase(work, "cuda")
        log(f"phase 15 results ({smi}): {json.dumps(loads)}")
        trained = training(work, "cuda")
        log(f"phase 11 results ({smi}): {json.dumps(trained, default=str)}")
        t = time.perf_counter()
        cli = cli_phase(work, "cuda")
        log(f"phase 12 seconds: {time.perf_counter() - t:.2f} ({smi})")
        mesh = mesh_phase(work, "cuda", self_index)
        log(f"phase 13 results ({smi}): {json.dumps(mesh, default=str)}")
        train_mesh = train_mesh_phase(work, "cuda", trained["contrastive"])
        log(f"phase 14 results ({smi}): {json.dumps(train_mesh, default=str)}")
        timing["attention_full"]["rotary_shapes"] = family["d_at_rotary_shapes"]
        timing["attention_full"]["training_shapes"] = grads["attention_full"]
        timing["attention_full"]["train_mesh_shape"] = train_mesh["two_by_two"]["d_local_heads"]
        timing["attention_flash"]["training_shapes"] = grads["attention_flash"]
        for name in ("fused_cosine_topk", "fused_cosine_topk_int8"):
            timing[name]["sharded"] = mesh["direct"][name]
        kernels = []
        # launches: phase 7's counted paths, bge-small's index, its bf16 and
        # int8 queries (the "search" route) and the direct S=2048 call of the
        # encoder attention that only e serves (the "direct" route), phase
        # 9's (the waves, MCP, HTTP) and phase 10's (Nomic, ModernBERT,
        # rerank), phase 11's (train and the searches after it, train
        # --cross-encoder and the reranked searches, the contrastive steps)
        # phase 12's (search --all-repos), phase 13's (the sessions, the
        # data-parallel embedding and the index on a mesh: "sharded") and
        # phase 14's (the training mesh's steps, every rank's: "train_mesh"),
        # each counted on its own
        paths = {**bert["launches"], **served["launches"], **family["launches"],
                 **trained["launches"], **cli["launches"], **mesh["launches"],
                 **train_mesh["launches"]}
        for name, via in (("fused_cosine_topk", "search"), ("fused_cosine_topk_int8", "search"),
                          ("fused_scores_topk", "search"), ("attention_full", "search"),
                          ("attention_flash", "direct"), ("attention_window", "modernbert")):
            by_path = {path: c[name] for path, c in paths.items() if c[name]}
            kernels.append({"name": name, "route": "cuda", "via": via, "source": SOURCES[name],
                            "replaces": REPLACES[name], "launches": sum(by_path.values()),
                            "launches_by_path": by_path, **timing[name]})
        # f's path is the head-packing ablation (phase 8), counted on its own
        kernels.append({"name": "attention_packed", "route": "cuda", "via": "ablation",
                        "source": SOURCES["attention_packed"],
                        "replaces": REPLACES["attention_packed"],
                        "launches": ablation["attention_packed"],
                        "launches_by_path": {"ablation": ablation["attention_packed"]},
                        **timing["attention_packed"]})
        check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
        check(all(k["launches_by_path"].get("sharded", 0) > 0 for k in kernels
                  if k["name"] in ("fused_cosine_topk", "fused_cosine_topk_int8",
                                   "fused_scores_topk", "attention_full")),
              "a kernel of the sharded path never launched there")
        check(next(k for k in kernels if k["name"] == "attention_full")["launches_by_path"]
              .get("train_mesh", 0) > 0, "kernel d never launched on the training mesh")
        jax_side = _jax_side()
        check(not jax_side, f"jax or the JAX package was imported: {jax_side[:5]}")
        print(json.dumps({"kernels": kernels}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
