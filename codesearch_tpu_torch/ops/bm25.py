"""Device BM25 over resident postings (port of ``codesearch_tpu/ops/bm25.py``).

The postings live on the device as ``p_pos`` (``slot | kind << SLOT_BITS``,
``PACK_PAD`` for padding and dead postings) and ``p_w`` (idf-less BM25
contributions). A query ships its terms' CSR intervals pre-split into
``CHUNK``-aligned slices; one call gathers them, applies idf, sorts by the
packed slot, sums each run, boosts the wanted kind and takes the top-k.
High-df terms read resident score planes instead (``_merge_dense``), whose
dense leg selects with the hand-written ``fused_scores_topk`` kernel.

JAX semantics kept on purpose: a chunk start clamps to ``[0, P - CHUNK]``
as ``lax.dynamic_slice`` does; out-of-range scatter targets are dropped as
``mode="drop"`` does; sorts are stable, as ``lax.sort_key_val`` is, so run
totals add in the same order; ties in every top-k keep the lowest index.
"""

from __future__ import annotations

import torch

from .fused_topk import fused_scores_topk, select_topk_plain

KIND_BOOST = 3.0
CHUNK = 1024
DEAD_SLOT = -(1 << 20)
SLOT_BITS = 25
SLOT_MASK = (1 << SLOT_BITS) - 1
PACK_PAD = (1 << 31) - 1
_MERGE_SUB = 8


def _chunk_gather(arr: torch.Tensor, cstart: torch.Tensor) -> torch.Tensor:
    """``arr[s : s + CHUNK]`` for every start ``s`` -> [..., CHUNK], each start
    clamped to ``[0, len(arr) - CHUNK]`` like ``lax.dynamic_slice``."""
    start = cstart.long().clamp(0, arr.shape[0] - CHUNK)
    return arr[start[..., None] + torch.arange(CHUNK, device=arr.device)]


def plane_write_rows(planes, p_pos, p_w, cstart, clen, rows):
    """Build R resident score planes: gather each term's posting chunks,
    scatter their contributions into fresh [R, N] columns, and write the
    columns into a copy of the plane buffer at ``rows`` (a row equal to the
    buffer's row count is padding and dropped). The copy keeps the previous
    buffer intact for callers holding it, as the JAX version's functional
    update does."""
    n = planes.shape[1]
    r, c = cstart.shape
    pos2 = _chunk_gather(p_pos, cstart)
    w2 = _chunk_gather(p_w, cstart)
    livem = torch.arange(CHUNK, device=planes.device) < clen[:, :, None]
    slots = torch.where(livem, pos2 & SLOT_MASK, n).reshape(r, -1).long()
    w = torch.where(livem, w2, 0.0).reshape(r, -1)
    ridx = torch.arange(r, device=planes.device)[:, None].expand_as(slots)
    keep = slots < n
    cols = torch.zeros((r, n), dtype=torch.float32, device=planes.device)
    cols.index_put_((ridx[keep], slots[keep]), w[keep], accumulate=True)
    out = planes.clone()
    rows = rows.long()
    ok = rows < planes.shape[0]
    out[rows[ok]] = cols[ok]
    return out


def _dense_scores_topk(combined, slot_meta, boost_kid, kd):
    """Top-kd of the precomputed dense scores [B, N] with the kind boost and
    dead slots at -3e38: the ``fused_scores_topk`` kernel on a CUDA tensor
    (plain version on the CPU)."""
    kd = min(kd, combined.shape[1])
    return fused_scores_topk(combined, slot_meta, boost_kid, kd, DEAD_SLOT)


def _merge_dense(slot_meta, boost_kid, k, kp, pos_s, totals, is_end, slot_s,
                 kind_s, pw, planes):
    """Planes-enabled selection tail over sub-batches of ``_MERGE_SUB``
    queries (bounds the [SUB, N] combined matrix)."""
    b = pw.shape[0]
    if b <= _MERGE_SUB or b % _MERGE_SUB:
        return _merge_dense_rows(slot_meta, boost_kid, k, kp, pos_s, totals,
                                 is_end, slot_s, kind_s, pw, planes)
    outs = [
        _merge_dense_rows(slot_meta, boost_kid[g:g + _MERGE_SUB], k, kp,
                          pos_s[g:g + _MERGE_SUB], totals[g:g + _MERGE_SUB],
                          is_end[g:g + _MERGE_SUB], slot_s[g:g + _MERGE_SUB],
                          kind_s[g:g + _MERGE_SUB], pw[g:g + _MERGE_SUB], planes)
        for g in range(0, b, _MERGE_SUB)
    ]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _merge_dense_rows(slot_meta, boost_kid, k, kp, pos_s, totals, is_end,
                      slot_s, kind_s, pw, planes):
    """Exact top-k from the sparse run totals plus the dense plane scores
    (proof of exactness: ``codesearch_tpu/ops/bm25.py`` _merge_dense_rows).
    ``combined = pw @ planes`` completes every sparse run's score; the dense
    leg's top-kp covers docs with no sparse match; a doc found by both legs
    keeps its sparse (full-score) copy."""
    neg = -3.0e37
    n = slot_meta.shape[0]
    combined = pw @ planes      # [B, N], full f32: TF32 is off (package __init__)
    dense_at = torch.gather(combined, 1, slot_s.clamp(max=n - 1).long())
    boost = torch.where(kind_s == boost_kid[:, None], KIND_BOOST, 1.0)
    runs = torch.where(is_end & (pos_s < PACK_PAD), (totals + dense_at) * boost,
                       float("-inf"))
    sv, ridx = select_topk_plain(runs, kp)
    scand = torch.gather(slot_s, 1, ridx.long()).int()
    s_ok = sv > neg
    dv, dcand = _dense_scores_topk(combined, slot_meta, boost_kid, kp)
    cand = torch.cat([scand, dcand], dim=1)
    vals = torch.cat([torch.where(s_ok, sv, float("-inf")), dv], dim=1)
    cc = cand.clamp(0, n - 1).long()
    live = (slot_meta[cc] != DEAD_SLOT) & (cand < n)
    vals = torch.where(live, vals, float("-inf"))
    s_sorted = torch.sort(torch.where(s_ok, scand, n + 1), dim=1).values
    di = torch.searchsorted(s_sorted, dcand.contiguous()).clamp(0, kp - 1)
    dup = torch.gather(s_sorted, 1, di) == dcand
    vals = torch.cat([vals[:, :kp], torch.where(dup, float("-inf"), vals[:, kp:])], dim=1)
    out_v, sel = select_topk_plain(vals, min(k, vals.shape[1]))
    return out_v, torch.gather(cand, 1, sel.long())


def _bm25_batch_core(p_pos, p_w, slot_meta, cstart, clen, cidf, boost_kid, k,
                     kpre, imax, pw=None, planes=None):
    """Batched core over B queries: chunk gather -> idf -> stable sort by
    packed slot -> ceil(log2(imax)) shifted compare-adds that leave each
    run's total at its run end -> kind boost -> top-kpre -> liveness
    re-rank to top-k (or the planes tail when ``planes`` is given)."""
    n = slot_meta.shape[0]
    b, c = cstart.shape
    pos2 = _chunk_gather(p_pos, cstart)
    w2 = _chunk_gather(p_w, cstart)
    live = torch.arange(CHUNK, device=p_pos.device) < clen[:, :, None]
    pos = torch.where(live, pos2, PACK_PAD).reshape(b, -1)
    w = torch.where(live, w2 * cidf[:, :, None], 0.0).reshape(b, -1)
    pos_s, order = torch.sort(pos, dim=1, stable=True)
    w_s = torch.gather(w, 1, order)
    neq = pos_s[:, 1:] != pos_s[:, :-1]
    is_end = torch.cat([neq, torch.ones((b, 1), dtype=torch.bool, device=neq.device)], dim=1)
    totals = w_s
    s = 1
    while s < imax:
        same = torch.cat([torch.zeros((b, s), dtype=torch.bool, device=pos_s.device),
                          pos_s[:, s:] == pos_s[:, :-s]], dim=1)
        shifted = torch.cat([torch.zeros((b, s), dtype=totals.dtype, device=totals.device),
                             totals[:, :-s]], dim=1)
        totals = totals + torch.where(same, shifted, 0.0)
        s *= 2
    kind_s = pos_s >> SLOT_BITS                 # arithmetic: PACK_PAD -> 63
    slot_s = pos_s & SLOT_MASK
    kp = min(max(kpre, k), totals.shape[1])
    if planes is not None:
        return _merge_dense(slot_meta, boost_kid, k, kp, pos_s, totals, is_end,
                            slot_s, kind_s, pw, planes)
    boost = torch.where(kind_s == boost_kid[:, None], KIND_BOOST, 1.0)
    runs = torch.where(is_end & (pos_s < PACK_PAD), totals * boost, float("-inf"))
    vals, ridx = select_topk_plain(runs, kp)
    cand = torch.gather(slot_s, 1, ridx.long()).int()
    if kp > k:
        alive = slot_meta[cand.clamp(0, max(n - 1, 0)).long()] != DEAD_SLOT
        vals = torch.where(alive, vals, float("-inf"))
        vals, sel = select_topk_plain(vals, min(k, kp))
        cand = torch.gather(cand, 1, sel.long())
    return vals, cand


def bm25_resident_topk(p_pos, p_w, slot_meta, cstart, clen, cidf, boost_kid,
                       k: int, kpre: int, imax: int, pw=None, planes=None):
    """Single query: the B=1 slice of ``_bm25_batch_core`` -> ([k] f32,
    [k] i32 doc slots)."""
    kid = torch.as_tensor(boost_kid, dtype=torch.int32, device=p_pos.device).reshape(1)
    vals, cand = _bm25_batch_core(
        p_pos, p_w, slot_meta, cstart[None], clen[None], cidf[None], kid, k,
        kpre, imax, pw[None] if pw is not None else None, planes)
    return vals[0], cand[0]


def bm25_resident_topk_batch(p_pos, p_w, slot_meta, cstart, clen, cidf,
                             boost_kid, k: int, kpre: int, imax: int, pw=None,
                             planes=None):
    """B independent queries' BM25 top-k in one call."""
    return _bm25_batch_core(p_pos, p_w, slot_meta, cstart, clen, cidf,
                            boost_kid, k, kpre, imax, pw, planes)
