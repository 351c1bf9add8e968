"""Token statistics of many texts at once, in numpy: how many tokens
``tokenizer.code_tokens`` gives each text, and how often given terms occur
in each. The same splitting rules as ``code_tokens``, applied to the bytes of
a block of texts with array operations, so that a quarter of a million
chunks take seconds and not minutes. ASCII text is assumed, as the
benchmark's generators write only ASCII (bytes of 0x80 and above count as
letters, as ``code_tokens`` counts them, but are not lowercased)."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

BLOCK_BYTES = 1 << 25
_P = np.uint64(0x100000001B3)


def _blocks(texts: list[str]):
    at, size, start = 0, 0, 0
    for i, t in enumerate(texts):
        size += len(t) + 1
        if size >= BLOCK_BYTES:
            yield start, i + 1
            start, size = i + 1, 0
        at = i + 1
    if start < at:
        yield start, at


def _spans(texts: list[str]):
    """(lowercased bytes, span starts, span ends, text index of each span)
    of every token ``code_tokens`` yields for these texts."""
    enc = [t.encode("utf-8", errors="replace") for t in texts]
    lens = np.fromiter(map(len, enc), np.int64, len(enc))
    buf = np.frombuffer(b"\n".join(enc) + b"\n", np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    up = (buf >= 65) & (buf <= 90)
    lo = (buf >= 97) & (buf <= 122)
    dg = (buf >= 48) & (buf <= 57)
    aln = up | lo | dg | (buf >= 128)
    word = aln | (buf == 95)

    def prev(a):
        return np.concatenate([[False], a[:-1]])

    def nxt(a):
        return np.concatenate([a[1:], [False]])

    p_aln = prev(aln)
    camel = aln & p_aln & ((prev(lo | dg) & up) | (prev(up) & up & nxt(lo)))
    piece_start = aln & (~p_aln | camel)
    piece_end = aln & (~nxt(aln) | nxt(camel))
    ps = np.flatnonzero(piece_start)
    pe = np.flatnonzero(piece_end) + 1
    ws = np.flatnonzero(word & ~prev(word))
    we = np.flatnonzero(word & ~nxt(word)) + 1
    per_word = np.bincount(np.searchsorted(ws, ps, "right") - 1, minlength=len(ws))
    whole = per_word >= 2
    s = np.concatenate([ps, ws[whole]])
    e = np.concatenate([pe, we[whole]])
    lb = buf + (up.astype(np.uint8) << 5)
    tid = np.searchsorted(starts, s, "right") - 1
    return lb, s, e, tid


def token_counts(texts: list[str]) -> np.ndarray:
    """``len(code_tokens(t))`` for every text."""
    out = np.zeros(len(texts), np.int64)
    for a, b in _blocks(texts):
        _lb, _s, _e, tid = _spans(texts[a:b])
        out[a:b] = np.bincount(tid, minlength=b - a)
    return out


def _hash(lb: np.ndarray, s: np.ndarray, n: np.ndarray) -> np.ndarray:
    h = np.zeros(len(s), np.uint64)
    for k in range(int(n.max(initial=0))):
        live = n > k
        h[live] = h[live] * _P + lb[s[live] + k].astype(np.uint64)
    return h


def _term_hash(term: str) -> int:
    b = np.frombuffer(term.encode(), np.uint8)
    return int(_hash(b, np.zeros(1, np.int64), np.asarray([len(b)]))[0])


def _block_counts(args):
    """Token counts and term occurrences of one block of texts."""
    texts, keys, hashes, order = args
    lb, s, e, tid = _spans(texts)
    counts = np.bincount(tid, minlength=len(texts))
    n = e - s
    key = n * 65536 + lb[s].astype(np.int64) * 256 + lb[e - 1].astype(np.int64)
    cand = np.isin(key, keys)
    if not cand.any() or not len(hashes):
        z = np.zeros(0, np.int64)
        return counts, z, z
    h = _hash(lb, s[cand], n[cand])
    at = np.searchsorted(hashes, h)
    ok = at < len(hashes)
    ok[ok] = hashes[at[ok]] == h[ok]
    return counts, tid[cand][ok], order[at[ok]]


def term_counts(texts: list[str], terms: list[str], workers: int = 1):
    """(token counts [T], occurrences as (text index, term index, count)
    arrays) for lowercased ``terms``; blocks of texts spread over
    ``workers`` processes."""
    raw = [t.encode("utf-8", errors="replace") for t in terms if t]
    keys = np.asarray(sorted({len(b) * 65536 + b[0] * 256 + b[-1] for b in raw}), np.int64)
    th = {_term_hash(t): i for i, t in enumerate(terms) if t}
    hashes = np.asarray(sorted(th), np.uint64)
    order = np.asarray([th[int(h)] for h in hashes], np.int64)
    blocks = list(_blocks(texts))
    jobs = [(texts[a:b], keys, hashes, order) for a, b in blocks]
    if workers > 1 and len(blocks) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(blocks)), mp_context=ctx) as pool:
            results = list(pool.map(_block_counts, jobs))
    else:
        results = [_block_counts(j) for j in jobs]
    counts = np.zeros(len(texts), np.int64)
    out_t, out_k = [], []
    for (a, b), (c, t, k) in zip(blocks, results):
        counts[a:b] = c
        out_t.append(t + a)
        out_k.append(k)
    t = np.concatenate(out_t) if out_t else np.zeros(0, np.int64)
    k = np.concatenate(out_k) if out_k else np.zeros(0, np.int64)
    pair, tf = np.unique(t * max(len(terms), 1) + k, return_counts=True)
    return counts, (pair // max(len(terms), 1), pair % max(len(terms), 1), tf)
