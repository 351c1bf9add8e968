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
   top-k kernels a, b, c at Q in {1, 9} query variants, N=262,144 rows,
   d=384, k in {10, 200, 500}, and at Q=9 also k=1024 and the bound k=4096
   (two merge levels), B in {1, 8} score rows for c, with exact ties and
   invalid rows, and k above the bound raising; attention kernels d and e
   in bf16 at bge-small's heads (H=12, Dh=32) with B=256 and S in {64, 256,
   512} for d and e, Dh=64 at S=512, e at S in {1024, 2048}, ragged S and
   d's sequence bound as the card reports it, the encoder's layout (strided
   views of one fused QKV projection) at S in {64, 512}, with padded masks
   and a fully masked row, and window, bias2d, requires_grad and unsupported
   inputs raising;
4. indexes the port's own ``codesearch_tpu_torch/`` sources with the port
   (code-hash-384) and searches that index through the port's CLI
   (``--json``);
5. builds a 262,144-chunk synthetic index through the port's write plane
   (code-hash-384, bf16), answers hybrid, vector-only and identifier
   queries through a port ``SearchSession`` on the GPU, checks the answers
   against the same session on the CPU (plain versions), counts kernel
   launches, then repeats a short pass on the int8 corpus;
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
   for P=4 and P=2, with ragged masks and a fully masked row, at ragged S,
   on the encoder's strided views and at its sequence bound, with refused
   inputs raising; then the ablation entry point
   (``codesearch_tpu_torch.examples.ablate_head_packing``) at its defaults,
   its launches of f counted on their own, and its table logged.

Beside each kernel's time it prints its bound on the card (the larger of
the bytes it must move over 3.35 TB/s and its operations over the peak rate
of their type) and, where one PyTorch call computes the same function, that
call's time (``library_ms``: ``scaled_dot_product_attention`` for d, e, f;
``torch.topk`` over the pre-boosted rows for c; none for a and b). It
prints one JSON line of per-kernel results, the ``nvidia-smi`` name and
power-limit line, and last the result line the harness reads. It fails if
``jax`` or any module of the JAX package ``codesearch_tpu`` was imported.
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
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
_TOPK_CU = "codesearch_tpu_torch/csrc/topk_kernels.cu"
_ATTN_CU = "codesearch_tpu_torch/csrc/attention_kernels.cu"
SOURCES = {
    "fused_cosine_topk": _TOPK_CU,
    "fused_cosine_topk_int8": _TOPK_CU,
    "fused_scores_topk": _TOPK_CU,
    "attention_full": _ATTN_CU,
    "attention_flash": _ATTN_CU,
    "attention_packed": _ATTN_CU,
}
REPLACES = {
    "fused_cosine_topk": "codesearch_tpu/ops/pallas_topk.py:244",
    "fused_cosine_topk_int8": "codesearch_tpu/ops/pallas_topk.py:201",
    "fused_scores_topk": "codesearch_tpu/ops/pallas_topk.py:164",
    "attention_full": "codesearch_tpu/ops/attention.py:110",
    "attention_flash": "codesearch_tpu/ops/attention.py:140",
    "attention_packed": "examples/ablate_head_packing.py:88",
}
# the kernels' plain versions: none may run on the card's main path (the
# head-packing ablation computes reference_attention as its reference row)
PLAIN_VERSIONS = {
    "codesearch_tpu_torch.ops.fused_topk": (
        "fused_cosine_topk_plain", "fused_cosine_topk_int8_plain", "fused_scores_topk_plain"),
    "codesearch_tpu_torch.ops.attention": (
        "attention_full_plain", "attention_flash_plain", "reference_attention"),
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


def sdpa_ms(q, k, v, mask) -> float:
    """``library_ms`` of an attention kernel: one scaled_dot_product_attention
    call with the same additive mask (timed here only; the port never calls it)."""
    import torch.nn.functional as F

    from codesearch_tpu_torch.examples.ablate_head_packing import cuda_ms

    bias = ((1.0 - mask.float()) * -1e30)[:, None, None, :].to(q.dtype)
    return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias), reps=10)


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
    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.ops.bm25 import DEAD_SLOT
    from codesearch_tpu_torch.ops.topk import quantize_rows_int8

    gen = torch.Generator().manual_seed(0)
    c, valid = make_corpus(N_ROWS, DIMS, gen)
    q9 = (c[:N_QUERIES] + 0.02 * torch.randn(N_QUERIES, DIMS, generator=gen)).to(device)
    cb = c.to(torch.bfloat16).to(device)
    vd = valid.to(device)
    cq, scale = quantize_rows_int8(c)
    cq, scale = cq.to(device), scale.to(device)
    results = {}
    # a multi-word query has one variant, an identifier up to nine; k=1024
    # and the bound run the two-level merge (512 first-pass blocks)
    cases = [(q, k) for q in (q9[:1].contiguous(), q9) for k in (10, 200, 500)]
    cases += [(q9, 1024), (q9, ft.MAX_K)]
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

    meta = torch.randint(0, 6, (N_ROWS,), generator=gen, dtype=torch.int32)
    meta[torch.rand(N_ROWS, generator=gen) < 0.05] = DEAD_SLOT
    md = meta.to(device)
    for b in (1, 8):
        s = torch.rand(b, N_ROWS, generator=gen)
        s[:, ::3] = 0.0                                   # docs without a dense term
        s[:, 1::5] = s[:, 0::5][:, : s[:, 1::5].shape[1]]  # exact ties
        kid = torch.arange(b, dtype=torch.int32) % 7 - 1  # -1: no boost
        sd, kd = s.to(device), kid.to(device)
        for k in (10, 256, 500, 1024, ft.MAX_K):
            got = ft.fused_scores_topk(sd, md, kd, k, DEAD_SLOT)
            torch.cuda.synchronize()
            ref = ft.fused_scores_topk_plain(sd, md, kd, k, DEAD_SLOT)
            same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            log(f"kernel c fused_scores_topk B={b} N={N_ROWS} k={k}: values and "
                f"indices equal: {same}")
            check(same, f"fused_scores_topk disagrees at B={b} k={k}")
            results.setdefault("fused_scores_topk", {})[(b, k)] = float(
                (got[0] - ref[0]).abs().max())

    # above the bound a wrapper given CUDA tensors raises and launches nothing
    before = dict(ft.launch_counts)
    for name, call in (
            ("fused_cosine_topk", lambda: ft.fused_cosine_topk(q9, cb, vd, ft.MAX_K + 1)),
            ("fused_cosine_topk_int8",
             lambda: ft.fused_cosine_topk_int8(q9, cq, scale, vd, ft.MAX_K + 1)),
            ("fused_scores_topk",
             lambda: ft.fused_scores_topk(sd, md, kd, ft.MAX_K + 1, DEAD_SLOT))):
        try:
            call()
        except ValueError as e:
            log(f"{name} k={ft.MAX_K + 1} raises: {e}")
        else:
            raise SmokeFailure(f"{name} accepted k={ft.MAX_K + 1} above its bound")
    check(ft.launch_counts == before, "a wrapper launched above the k bound")

    # times at the main path's shapes: a hybrid query's fetch=200 vector
    # top-k over its variants (1 for a multi-word query, up to 9), and the
    # dense BM25 leg's kp=256 selection over one score row. The first shape
    # of each kernel is the one reported in the JSON line.
    s1 = torch.rand(1, N_ROWS, generator=gen).to(device)
    k1 = torch.tensor([2], dtype=torch.int32, device=device)
    timed = {"fused_cosine_topk": [], "fused_cosine_topk_int8": [], "fused_scores_topk": []}
    for q in (q9[:1].contiguous(), q9):
        timed["fused_cosine_topk"].append((
            f"Q={q.shape[0]} k=200", lambda q=q: ft.fused_cosine_topk(q, cb, vd, 200),
            lambda q=q: ft.fused_cosine_topk_plain(q, cb, vd, 200)))
        timed["fused_cosine_topk_int8"].append((
            f"Q={q.shape[0]} k=200", lambda q=q: ft.fused_cosine_topk_int8(q, cq, scale, vd, 200),
            lambda q=q: ft.fused_cosine_topk_int8_plain(q, cq, scale, vd, 200)))
    timed["fused_scores_topk"].append((
        "B=1 k=256", lambda: ft.fused_scores_topk(s1, md, k1, 256, DEAD_SLOT),
        lambda: ft.fused_scores_topk_plain(s1, md, k1, 256, DEAD_SLOT)))
    out = {}
    for name, shapes in timed.items():
        for shape, kern, plain in shapes:
            t_plain_1 = cuda_ms(plain)
            t_kern_1 = cuda_ms(kern)
            t_kern_2 = cuda_ms(kern)
            t_plain_2 = cuda_ms(plain)
            out.setdefault(name, {
                "max_abs_err": max(results[name].values()),
                "ms": min(t_kern_1, t_kern_2),
                "plain_ms": min(t_plain_1, t_plain_2),
            })
            log(f"time {name} {shape} N={N_ROWS}: kernel {t_kern_1}/{t_kern_2} ms, plain "
                f"{t_plain_1}/{t_plain_2} ms (median of 20, plain-kernel-kernel-plain)")
    # bounds at the reported shapes: a and b at Q=1, k=200 (the corpus read
    # dominates), c at one score row, k=256, each counting only the rows this
    # run's data needs (valid corpus rows, live score slots) besides every
    # row's flag; no one PyTorch call computes a or b (a masked cosine matmul
    # plus a top-k with the lowest index on ties)
    n_valid, n_live = int(vd.sum()), int((md != DEAD_SLOT).sum())
    out["fused_cosine_topk"].update(
        bound(n_valid * DIMS * 2 + N_ROWS + DIMS * 4 + 200 * 8, 2 * n_valid * DIMS, "bf16"),
        library_ms=None)
    out["fused_cosine_topk_int8"].update(
        bound(n_valid * (DIMS + 4) + N_ROWS + DIMS * 4 + 200 * 8, 2 * n_valid * DIMS, "int8"),
        library_ms=None)
    boosted = torch.where(md[None, :] == DEAD_SLOT, ft.NEG_INF,
                          s1 * torch.where(md[None, :] == k1[:, None], 3.0, 1.0))
    out["fused_scores_topk"].update(
        bound(n_live * 4 + N_ROWS * 4 + 4 + 256 * 8, n_live, "f32"),
        library_ms=cuda_ms(lambda: torch.topk(boosted, 256, dim=1)))
    for name, v in out.items():
        log(f"bound {name}: {v['bound_ms']} ms ({v['bound_by']}); kernel {v['ms']} ms; "
            f"library call {v['library_ms']} ms")
    return out


def attention_inputs(b: int, h: int, s: int, dh: int, seed: int, device: str,
                     fused_qkv: bool = False):
    """bf16 [B, H, S, Dh] q, k, v (normal) and a [B, S] padding mask with
    random lengths: row 0 full, the last row fully masked. ``fused_qkv``
    makes q, k and v the encoder's strided views of one [B, S, 3 * H * Dh]
    projection instead of contiguous tensors."""
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
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.float32).to(device)
    return q, k, v, mask


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

    bound = {dh: att.full_max_seq(dh, device) for dh in att.HEAD_DIMS}
    log(f"kernel d's sequence bound from the card's shared memory a block: {bound}")
    if "H100" in torch.cuda.get_device_name(0):
        check(bound == att.H100_FULL_MAX_SEQ,
              f"kernel d's bound {bound} on an H100 is not {att.H100_FULL_MAX_SEQ}")
    # (name, B, H, S, Dh, timed, fused_qkv): bge-small's buckets at its batch
    # of 256, bge-base/large's head size at S=512, e at d's bge-small shapes,
    # ragged S, each sequence bound, and the encoder's layout (q, k, v views
    # of one fused projection) at bge-small's shortest and longest bucket
    cases = [("attention_full", 256, 12, 64, 32, True, False),
             ("attention_full", 256, 12, 256, 32, True, False),
             ("attention_full", 256, 12, 512, 32, True, False),
             ("attention_full", 128, 12, 512, 64, True, False),
             ("attention_full", 4, 12, 100, 32, False, False),
             ("attention_full", 2, 12, bound[32], 32, False, False),
             ("attention_full", 2, 12, bound[64], 64, False, False),
             ("attention_full", 256, 12, 64, 32, False, True),
             ("attention_full", 256, 12, 512, 32, False, True),
             ("attention_flash", 256, 12, 64, 32, True, False),
             ("attention_flash", 256, 12, 256, 32, True, False),
             ("attention_flash", 256, 12, 512, 32, True, False),
             ("attention_flash", 32, 12, 1024, 32, True, False),
             ("attention_flash", 8, 12, 2048, 32, True, False),
             ("attention_flash", 16, 12, 1024, 64, False, False),
             ("attention_flash", 4, 12, 1000, 32, False, False),
             ("attention_flash", 256, 12, 512, 32, False, True)]
    kernels = {"attention_full": (att.attention_full, att.attention_full_plain),
               "attention_flash": (att.attention_flash, att.attention_flash_plain)}
    errs: dict = collections.defaultdict(float)
    out: dict = {}
    for i, (name, b, h, s, dh, timed, fused_qkv) in enumerate(cases):
        kern, plain = kernels[name]
        q, k, v, mask = attention_inputs(b, h, s, dh, seed=i, device=device, fused_qkv=fused_qkv)
        got = kern(q, k, v, mask)
        torch.cuda.synchronize()
        ref = plain(q.contiguous(), k.contiguous(), v.contiguous(), mask)
        err, share, ok = compare_attention(got, ref)
        finite = bool(torch.isfinite(got).all())
        layout = "views of a fused QKV projection" if fused_qkv else "contiguous"
        log(f"kernel {'d' if name == 'attention_full' else 'e'} {name} B={b} H={h} S={s} "
            f"Dh={dh} ({layout}): max |out - plain| {err} (tol {ATTN_ATOL} + "
            f"{ATTN_RTOL}|plain|), share of outputs differing {share:.2e}, all finite "
            f"{finite}, fully masked row {got[-1, 0, 0, :4].float().tolist()}")
        check(ok and finite, f"{name} disagrees with its plain version at B={b} S={s} "
              f"Dh={dh} ({layout})")
        errs[name] = max(errs[name], err)
        if timed:
            t_plain_1 = cuda_ms(lambda: plain(q, k, v, mask), reps=10)
            t_kern_1 = cuda_ms(lambda: kern(q, k, v, mask), reps=10)
            t_kern_2 = cuda_ms(lambda: kern(q, k, v, mask), reps=10)
            t_plain_2 = cuda_ms(lambda: plain(q, k, v, mask), reps=10)
            # the JSON line reports d at bge-small's largest bucket, e at S=2048
            if (name, s, dh) in (("attention_full", 512, 32), ("attention_flash", 2048, 32)):
                out[name] = {"ms": min(t_kern_1, t_kern_2), "plain_ms": min(t_plain_1, t_plain_2),
                             **attention_bound(q, mask), "library_ms": sdpa_ms(q, k, v, mask)}
                log(f"bound {name} B={b} H={h} S={s} Dh={dh}: {out[name]['bound_ms']} ms "
                    f"({out[name]['bound_by']}); scaled_dot_product_attention "
                    f"{out[name]['library_ms']} ms")
            log(f"time {name} B={b} H={h} S={s} Dh={dh}: kernel {t_kern_1}/{t_kern_2} ms, "
                f"plain {t_plain_1}/{t_plain_2} ms (median of 10, plain-kernel-kernel-plain)")
        del q, k, v, mask, got, ref
        torch.cuda.empty_cache()

    # what the kernels do not take raises on the card and launches nothing
    q, k, v, mask = attention_inputs(2, 12, 64, 32, seed=99, device=device)
    z48 = torch.zeros(2, 12, 64, 48, dtype=torch.bfloat16, device=device)
    before = dict(att.launch_counts)
    for what, call, exc in (
            ("window", lambda: att.fused_encoder_attention(q, k, v, mask, window=128),
             NotImplementedError),
            ("bias2d", lambda: att.fused_encoder_attention(
                q, k, v, mask, bias2d=torch.zeros(12, 64, 64, device=device)),
             NotImplementedError),
            ("requires_grad", lambda: att.fused_encoder_attention(
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

    # (B, H, S, P, timed, fused_qkv): the ablation's width for both P, its
    # shortest bucket, ragged S, the sequence bound and the encoder's views
    cases = [(256, 12, 512, 4, True, False), (256, 12, 512, 2, True, False),
             (256, 12, 64, 4, False, False), (256, 12, 64, 2, False, False),
             (4, 12, 100, 4, False, False), (4, 8, 1000, 2, False, False),
             (2, 12, pa.PACKED_MAX_SEQ, 4, False, False), (256, 12, 512, 4, False, True)]
    err = 0.0
    out: dict = {}
    for i, (b, h, s, pack, timed, fused_qkv) in enumerate(cases):
        q, k, v, mask = attention_inputs(b, h, s, 32, seed=100 + i, device=device,
                                         fused_qkv=fused_qkv)
        got = pa.attention_packed(q, k, v, mask, pack)
        torch.cuda.synchronize()
        ref = pa.attention_packed_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                                        pack)
        e, share, ok = compare_attention(got, ref)
        d_err, d_share, _ = compare_attention(
            att.attention_full_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask), ref)
        finite = bool(torch.isfinite(got).all())
        layout = "views of a fused QKV projection" if fused_qkv else "contiguous"
        log(f"kernel f attention_packed B={b} H={h} S={s} P={pack} ({layout}): max |out - "
            f"plain| {e} (tol {ATTN_ATOL} + {ATTN_RTOL}|plain|), share of outputs differing "
            f"{share:.2e} (limit {PACKED_SHARE_MAX}; d's order: max {d_err}, share "
            f"{d_share:.2e}), all finite {finite}, fully masked row "
            f"{got[-1, 0, 0, :4].float().tolist()}")
        check(ok and finite and share <= PACKED_SHARE_MAX,
              f"attention_packed disagrees with its plain version at B={b} "
              f"H={h} S={s} P={pack} ({layout})")
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
            log(f"time attention_packed B={b} H={h} S={s} P={pack}: kernel {t_kern_1}/"
                f"{t_kern_2} ms, plain {t_plain_1}/{t_plain_2} ms (median of 10, plain-kernel-"
                f"kernel-plain); scaled_dot_product_attention {lib} ms; bound "
                f"{bnd['bound_ms']} ms ({bnd['bound_by']})")
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

def repo_index_and_cli(work: Path, device: str, model: str = "code-hash-384") -> None:
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
           "search", "exact cosine top-k over the corpus", str(ROOT / "codesearch_tpu_torch"),
           "--json", "--limit", "5"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env=os.environ.copy())
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


# ---------------------------------------------------------------------------
# phase 5: the synthetic corpus through SearchSession
# ---------------------------------------------------------------------------

HYBRID_QUERIES = ["validate the schema and return it"] + [
    f"{v} the {o} and return it" for v, o in zip(VERBS[:7], NOUNS[3:10])]
VECTOR_QUERIES = ["render widget metric", "merge the branch vector", "scan the socket",
                  "cache token matrix"]
# "shared_registry" alone expands to six query variants
IDENT_QUERIES = ["shared_registry sync", "where is shared_registry used", "shared_registry"]


def build_synthetic(db: Path, n_rows: int, device: str, model: str = "code-hash-384") -> dict:
    """bench.py's synthetic corpus through the port's write plane, with an
    identifier in every third chunk (df ~ n/3: above the 65,536 plane floor
    and below the 0.4 n stopword cap at n = 262,144)."""
    from codesearch_tpu_torch.embed import Chunk, ChunkKind, EmbeddingService
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
        chunks = []
        for i in range(a, min(n_rows, a + 8192)):
            v, o = VERBS[i % 15], NOUNS[(i // 15) % 15]
            extra = "    shared_registry.sync(arg)\n" if i % 3 == 0 else ""
            body = (f"def {v}_{o}_{i}(arg):\n"
                    f'    """{v.capitalize()} the {o} and return the result."""\n'
                    f"{extra}    return arg.{o} + {i}\n")
            g = i // 64
            chunks.append(Chunk(content=body, start_line=0, end_line=3,
                                kind=ChunkKind.FUNCTION, path=f"src/{NOUNS[g % 15]}/mod_{g}.py",
                                signature=f"def {v}_{o}_{i}(arg)"))
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


def device_busy_share(session, queries, mode: str) -> dict:
    """The device's idle share of a pass over uncached queries: device
    kernel time from a profiled pass, against the wall time of an
    unprofiled pass just before it (the profiler slows the host down, so
    its own wall time would overstate the idle share; both are printed)."""
    from torch.profiler import ProfilerActivity, profile

    wall_ms = timed_pass(session, queries, mode)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = timed_pass(session, queries, mode)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1000
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"queries": len(queries), "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1000 for e in top}}


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


def gpu_against_cpu(gpu, cpu, queries) -> dict:
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
        cids, scores = gpu.store.search_encoded(gpu.service.backend.encoder, ids, mask,
                                                st["fetch"], raw=True)
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
    log(f"GPU vs CPU session ({BERT_MODEL}): {json.dumps(out)}")
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


def nvidia_smi_line() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
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
        repo_index_and_cli(work, "cuda")
        synthetic_session(work, N_ROWS, "cuda", cpu_check=True)
        from codesearch_tpu_torch.ops import attention as att

        att.reset_launch_counts()
        repo_index_and_cli(work, "cuda", model=BERT_MODEL)
        log(f"{BERT_MODEL} index of codesearch_tpu_torch/: attention launches by (kernel, S) "
            f"{dict(att.launches_by_seq)}")
        bert = bert_synthetic(work, N_ROWS, "cuda")
        timing.update(packed_checks("cuda"))
        ablation = packed_ablation(work)
        kernels = []
        # launches: phase 7's counted paths, bge-small's index, its bf16 and
        # int8 queries (the "search" route) and the direct S=2048 call of the
        # encoder attention that only e serves (the "direct" route)
        for name, via in (("fused_cosine_topk", "search"), ("fused_cosine_topk_int8", "search"),
                          ("fused_scores_topk", "search"), ("attention_full", "search"),
                          ("attention_flash", "direct")):
            by_path = {path: c[name] for path, c in bert["launches"].items() if c[name]}
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
        jax_side = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                                         "codesearch_tpu"))
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
