"""The hash-model query in one call (port of
``codesearch_tpu/ops/query_pipeline.py``): embed the query variants, take
the exact vector top-k and, for hybrid queries, the BM25 top-k over the
resident postings. The results stay on the device; the caller reads the
four arrays back together."""

from __future__ import annotations

from ..models.hash_embedder import embed_features
from .bm25 import bm25_resident_topk
from .topk import cosine_topk, cosine_topk_int8


def hash_embed_search(table, ids, weights, corpus, valid, k: int):
    """[Q, T] features -> exact cosine top-k over the bf16 corpus."""
    return cosine_topk(embed_features(table, ids, weights), corpus, valid, k)


def hash_embed_search_int8(table, ids, weights, corpus_q, row_scale, valid, k: int):
    return cosine_topk_int8(embed_features(table, ids, weights), corpus_q,
                            row_scale, valid, k)


def hash_embed_hybrid_search(table, ids, weights, corpus, valid, kv: int,
                             p_pos, p_w, slot_meta, cstart, clen, cidf,
                             boost_kid, kb: int, kbpre: int, imax: int,
                             pw=None, planes=None):
    """Variant embedding + exact vector top-k + resident BM25 top-k ->
    (v_vals [Q, kv], v_idx [Q, kv], b_vals [kb], b_idx [kb])."""
    v_vals, v_idx = hash_embed_search(table, ids, weights, corpus, valid, kv)
    b_vals, b_idx = bm25_resident_topk(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                       boost_kid, kb, kbpre, imax, pw=pw, planes=planes)
    return v_vals, v_idx, b_vals, b_idx


def hash_embed_hybrid_search_int8(table, ids, weights, corpus_q, row_scale, valid,
                                  kv: int, p_pos, p_w, slot_meta, cstart, clen,
                                  cidf, boost_kid, kb: int, kbpre: int, imax: int,
                                  pw=None, planes=None):
    v_vals, v_idx = hash_embed_search_int8(table, ids, weights, corpus_q,
                                           row_scale, valid, kv)
    b_vals, b_idx = bm25_resident_topk(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                       boost_kid, kb, kbpre, imax, pw=pw, planes=planes)
    return v_vals, v_idx, b_vals, b_idx
