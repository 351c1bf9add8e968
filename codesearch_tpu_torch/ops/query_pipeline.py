"""The query in one call (port of ``codesearch_tpu/ops/query_pipeline.py``):
embed the query variants (hash model: a table gather; BERT family: the
encoder forward), take the exact vector top-k and, for hybrid queries, the
BM25 top-k over the resident postings. The results stay on the device; the
caller reads the arrays back together. The ``*_many`` functions take a
wave of queries at once. The BERT functions take the ``BertEncoder``, which
carries the JAX functions' ``params`` and ``cfg``."""

from __future__ import annotations

from ..models.hash_embedder import embed_features
from .bm25 import bm25_resident_topk, bm25_resident_topk_batch
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


def bert_embed_search(encoder, ids, mask, corpus, valid, k: int):
    """[Q, T] token ids + mask -> encoder forward -> exact cosine top-k over
    the bf16 corpus."""
    return cosine_topk(encoder.encode(ids, mask), corpus, valid, k)


def bert_embed_search_int8(encoder, ids, mask, corpus_q, row_scale, valid, k: int):
    return cosine_topk_int8(encoder.encode(ids, mask), corpus_q, row_scale, valid, k)


def bert_embed_hybrid_search(encoder, ids, mask, corpus, valid, kv: int,
                             p_pos, p_w, slot_meta, cstart, clen, cidf,
                             boost_kid, kb: int, kbpre: int, imax: int,
                             pw=None, planes=None):
    """Encoder forward + exact vector top-k + resident BM25 top-k ->
    (v_vals [Q, kv], v_idx [Q, kv], b_vals [kb], b_idx [kb])."""
    v_vals, v_idx = bert_embed_search(encoder, ids, mask, corpus, valid, kv)
    b_vals, b_idx = bm25_resident_topk(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                       boost_kid, kb, kbpre, imax, pw=pw, planes=planes)
    return v_vals, v_idx, b_vals, b_idx


def bert_embed_hybrid_search_int8(encoder, ids, mask, corpus_q, row_scale, valid,
                                  kv: int, p_pos, p_w, slot_meta, cstart, clen,
                                  cidf, boost_kid, kb: int, kbpre: int, imax: int,
                                  pw=None, planes=None):
    v_vals, v_idx = bert_embed_search_int8(encoder, ids, mask, corpus_q, row_scale,
                                           valid, kv)
    b_vals, b_idx = bm25_resident_topk(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                       boost_kid, kb, kbpre, imax, pw=pw, planes=planes)
    return v_vals, v_idx, b_vals, b_idx


def hash_embed_hybrid_search_many(table, ids, weights, corpus, valid, kv: int,
                                  p_pos, p_w, slot_meta, cstart, clen, cidf,
                                  boost_kid, kb: int, kbpre: int, imax: int,
                                  pw=None, planes=None):
    """A wave of B queries in one call: every query's variants concatenated
    along the rows ([Qtot, T]), B stacked BM25 interval tables ([B, C],
    ``fts.store.stack_query_args``) -> (v_vals [Qtot, kv], v_idx [Qtot, kv],
    b_vals [B, kb], b_idx [B, kb]). One launch of kernel a covers the wave."""
    v_vals, v_idx = hash_embed_search(table, ids, weights, corpus, valid, kv)
    b_vals, b_idx = bm25_resident_topk_batch(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                             boost_kid, kb, kbpre, imax, pw=pw,
                                             planes=planes)
    return v_vals, v_idx, b_vals, b_idx


def hash_embed_hybrid_search_many_int8(table, ids, weights, corpus_q, row_scale, valid,
                                       kv: int, p_pos, p_w, slot_meta, cstart, clen,
                                       cidf, boost_kid, kb: int, kbpre: int, imax: int,
                                       pw=None, planes=None):
    v_vals, v_idx = hash_embed_search_int8(table, ids, weights, corpus_q, row_scale,
                                           valid, kv)
    b_vals, b_idx = bm25_resident_topk_batch(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                             boost_kid, kb, kbpre, imax, pw=pw,
                                             planes=planes)
    return v_vals, v_idx, b_vals, b_idx


def bert_embed_hybrid_search_many(encoder, ids, mask, corpus, valid, kv: int,
                                  p_pos, p_w, slot_meta, cstart, clen, cidf,
                                  boost_kid, kb: int, kbpre: int, imax: int,
                                  pw=None, planes=None):
    """The BERT-family wave: one encoder forward over every query's variants
    ([Qtot, T]) + the batched vector and BM25 top-k, as
    ``hash_embed_hybrid_search_many``."""
    v_vals, v_idx = bert_embed_search(encoder, ids, mask, corpus, valid, kv)
    b_vals, b_idx = bm25_resident_topk_batch(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                             boost_kid, kb, kbpre, imax, pw=pw,
                                             planes=planes)
    return v_vals, v_idx, b_vals, b_idx


def bert_embed_hybrid_search_many_int8(encoder, ids, mask, corpus_q, row_scale, valid,
                                       kv: int, p_pos, p_w, slot_meta, cstart, clen,
                                       cidf, boost_kid, kb: int, kbpre: int, imax: int,
                                       pw=None, planes=None):
    v_vals, v_idx = bert_embed_search_int8(encoder, ids, mask, corpus_q, row_scale,
                                           valid, kv)
    b_vals, b_idx = bm25_resident_topk_batch(p_pos, p_w, slot_meta, cstart, clen, cidf,
                                             boost_kid, kb, kbpre, imax, pw=pw,
                                             planes=planes)
    return v_vals, v_idx, b_vals, b_idx
