"""How a ranked list the program produced is held to the reference's scores.

A list is judged by three gaps, each a share of ``scale`` (the reference's
best score, or 1 for cosines), and the largest is the list's number:

- score: how far a listed item's score lies from the reference's score
  for the same item;
- rank: how far the reference's score of the program's weakest item lies
  below the reference's own m-th best (m the list's length), so that an
  item left out in favour of a worse one shows, and a tie chosen otherwise
  does not;
- order: how far an item's reference score lies above its predecessor's.

A list shorter than the reference's (items with a positive score, up to
``k``), holding an item twice or a score that is not finite reads 1.
"""

from __future__ import annotations

import numpy as np


def list_gap(pairs, ref: np.ndarray, k: int, scale: float | None = None,
             positive_only: bool = False) -> float:
    """``pairs`` [(item, score)] in the program's order; ``ref`` the
    reference's score of every item (index = item)."""
    ref = np.asarray(ref, np.float64)
    cand = ref[ref > 0] if positive_only else ref
    want = min(k, len(cand))
    if scale is None:
        scale = float(cand.max()) if len(cand) else 1.0
    scale = scale if scale > 0 else 1.0
    if len(pairs) < want:
        return 1.0
    if not len(pairs):
        return 0.0
    items = np.asarray([int(c) for c, _ in pairs], np.int64)
    if len(np.unique(items)) != len(items) or items.min() < 0 or items.max() >= len(ref):
        return 1.0
    got = np.asarray([float(s) for _, s in pairs], np.float64)
    if not np.isfinite(got).all():
        return 1.0
    mine = ref[items]
    score_gap = float(np.abs(got - mine).max())
    m = min(len(items), len(cand))
    kth = float(np.partition(cand, len(cand) - m)[len(cand) - m]) if m else 0.0
    rank_gap = max(0.0, kth - float(mine.min()))
    order_gap = float(np.maximum(np.diff(mine), 0.0).max(initial=0.0))
    return max(score_gap, rank_gap, order_gap) / scale


def ranked_mismatch(got, want, rel: float = 1e-12) -> int:
    """Positions at which two [(score, item)] lists differ in item or in
    score beyond ``rel`` of the larger, plus the difference in length."""
    bad = abs(len(got) - len(want))
    for (gs, gi), (ws, wi) in zip(got, want):
        if int(gi) != int(wi) or abs(gs - ws) > rel * max(abs(gs), abs(ws), 1e-300):
            bad += 1
    return bad
