"""Training pairs mined from an indexed corpus (port of
``codesearch_tpu/train/data.py``).

Builds (query, document) pairs without any labeling service: docstring and
code body, signature and body, breadcrumb context and body. ``batches``
tokenizes them into fixed [B, max_len] batches in a seeded order;
``mine_hard_negatives`` ranks each pair's query against every mined
document with the hash retriever.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Pair:
    query: str
    doc: str


def mine_pairs(chunks: list, min_doc_len: int = 24) -> list[Pair]:
    """Pairs of chunks (``Chunk`` or the stores' ``ChunkMetadata``) whose
    body has at least ``min_doc_len`` characters."""
    pairs: list[Pair] = []
    for c in chunks:
        body = c.content
        if len(body) < min_doc_len:
            continue
        if c.docstring and len(c.docstring) >= 12:
            pairs.append(Pair(query=c.docstring, doc=body))
        if c.signature and len(c.signature) >= 8:
            pairs.append(Pair(query=c.signature, doc=body))
        if len(c.context) >= 2:
            pairs.append(Pair(query=" > ".join(c.context[1:]), doc=body))
    return pairs


def mine_hard_negatives(pairs: list[Pair], k: int = 4, dims: int = 384,
                        device=None) -> list[list[str]]:
    """Retriever-mined hard negatives, one list per pair: the top-k other
    documents the hash retriever (on ``device``) ranks for the pair's query.
    A reranker only scores documents the retriever already ranked high, so
    it trains against the retriever's own confusions."""
    seen: dict[str, int] = {}
    docs: list[str] = []
    for p in pairs:
        if p.doc not in seen:
            seen[p.doc] = len(docs)
            docs.append(p.doc)
    if len(docs) < 3:
        return [[] for _ in pairs]
    from ..models.hash_embedder import HashEmbedder

    he = HashEmbedder(dims, device=device)
    d_emb = he.embed_texts(docs)                      # [N, d]
    out: list[list[str]] = []
    bs = 256                                          # queries a slab
    for i in range(0, len(pairs), bs):
        slab = pairs[i : i + bs]
        q_emb = he.embed_texts([p.query for p in slab])
        sims = q_emb @ d_emb.T                        # [B, N]
        top = np.argsort(-sims, axis=1)[:, : k + 1]
        for row, p in enumerate(slab):
            own = seen[p.doc]
            out.append([docs[j] for j in top[row] if j != own][:k])
    return out


def batches(pairs: list[Pair], tokenizer, batch_size: int, max_len: int = 128,
            seed: int = 0):
    """Yield token batches: dicts of [B, max_len] int32 numpy arrays
    (``query_ids``, ``query_mask``, ``doc_ids``, ``doc_mask``) over a
    ``np.random.default_rng(seed)`` permutation; a short last batch is
    dropped."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[i : i + batch_size]
        q_ids = np.zeros((batch_size, max_len), np.int32)
        q_mask = np.zeros((batch_size, max_len), np.int32)
        d_ids = np.zeros((batch_size, max_len), np.int32)
        d_mask = np.zeros((batch_size, max_len), np.int32)
        for row, j in enumerate(idx):
            q = tokenizer.encode(pairs[j].query).ids[:max_len]
            d = tokenizer.encode(pairs[j].doc).ids[:max_len]
            q_ids[row, : len(q)] = q
            q_mask[row, : len(q)] = 1
            d_ids[row, : len(d)] = d
            d_mask[row, : len(d)] = 1
        yield {
            "query_ids": q_ids, "query_mask": q_mask,
            "doc_ids": d_ids, "doc_mask": d_mask,
        }
