"""One agent's hybrid queries, closed loop, through the read plane the MCP
server's serial stdio plane calls: ``server.readplane.ranked_chunks`` with
the stores' lock held, no batcher, over the port's ``SharedStores``.

Set-up writes the seeded weights, builds the corpus (texts through the
full-text store, clustered vectors through the vector store), opens the
service on the card and warms the read plane with queries of its own. The
window sends the next query when the last returns, until ``--seconds`` have
passed. The queries are distinct, as many as a program at the traffic's
``ceiling_per_s`` would send in the window; a faster program starts over
from the first rather than run out. Each query's three candidate lists, its
query vector and its ranked list are kept for a seeded sample; after the
window the sample is held to the reference: the query vector, the vector
leg, the BM25 leg and the exact-identifier leg to the reference's own
scores, and the ranked list to the reference's ranking arithmetic over the
program's candidate lists. With ``ctx.control`` the reference a precision
lower takes the program's place in the sample before it is judged.
"""

from __future__ import annotations

import math
import os
import random
import time
from typing import NamedTuple

import numpy as np
import torch

from ..gen.corpus import corpus_vectors, make_chunks
from ..gen.queries import make_queries
from ..reference import ranking
from ..reference.bm25 import Corpus, bf16, exact_target, query_terms
from ..reference.compare import list_gap, ranked_mismatch
from ..reference.encoder import Encoder, encode_texts, exact_float32, fp8_round
from ..reference.tokenizer import token_ids
from ..roofline import POSTING_BYTES, weight_bytes
from .common import (Outcome, Window, check_served_model, free_device, install_weights,
                     memory_peak, percentile, reference_weights, sync)

LIMIT = 10                   # hits an agent asks for (the MCP tool's default)
INSERT_BLOCK = 16384         # chunks a store insert
FTS_COMMIT_EVERY = 65536
SAMPLE_FROM = 1024           # the checked queries are drawn from the first this many
WORKERS = min(8, os.cpu_count() or 1)   # processes for the corpus text and the reference
PARALLEL_FROM = 65536                    # chunks from which those spread over WORKERS


def workers(n: int) -> int:
    return WORKERS if n >= PARALLEL_FROM else 1


def build(ctx, chunks, vecs, stores) -> None:
    from codesearch_tpu_torch.vectordb import ChunkMetadata

    for a in range(0, len(chunks), INSERT_BLOCK):
        b = min(len(chunks), a + INSERT_BLOCK)
        metas = [ChunkMetadata(path=chunks.path[i], content=chunks.content[i],
                               start_line=chunks.start[i], end_line=chunks.end[i],
                               kind=chunks.kind[i], signature=chunks.signature[i],
                               language=chunks.language[i]) for i in range(a, b)]
        with ctx.phase("vector store"):
            ids = stores.store.insert_chunks_with_ids(vecs[a:b].cpu().numpy(), metas)
        if ids != list(range(a, b)):
            raise RuntimeError("the vector store numbered the chunks otherwise")
        with ctx.phase("full-text store"):
            stores.fts.add_chunks([(i, m.content, m.path, m.signature, m.kind)
                                   for i, m in zip(ids, metas)])
            if b % FTS_COMMIT_EVERY == 0:
                stores.fts.commit()
    with ctx.phase("full-text store"):
        stores.fts.commit()
    with ctx.phase("vector store"):
        stores.store.build_index()


class Capture:
    """Wraps the read plane's layers to keep what each query produced (and,
    traced, to time them in spans)."""

    def __init__(self, ctx, service):
        from codesearch_tpu_torch.fts.store import FtsStore
        from codesearch_tpu_torch.server import readplane

        self.rec: dict = {}
        self.undo = []
        tr = ctx.tracer

        def patch(owner, name, new):
            old = getattr(owner, name)
            self.undo.append((owner, name, old, name in vars(owner)))
            setattr(owner, name, new)

        cands = readplane.device_candidates
        rank = readplane.rank_candidates
        search_exact = FtsStore.search_exact
        search = FtsStore.search
        encode = service.backend.encoder.encode

        def device_candidates(*a, **kw):
            vres, fres = cands(*a, **kw)
            self.rec["vres"], self.rec["fres"] = vres, fres
            return vres, fres

        def exact(store, *a, **kw):
            out = search_exact(store, *a, **kw)
            self.rec.setdefault("eres", []).append(out)
            return out

        def host_search(store, *a, **kw):
            out = search(store, *a, **kw)
            self.rec["fres_host"] = out
            return out

        def enc(*a, **kw):
            out = encode(*a, **kw)
            self.rec["qvec"] = out
            return out

        patch(readplane, "device_candidates", tr.wrap("bench.readplane.candidates",
                                                      device_candidates))
        patch(readplane, "rank_candidates", tr.wrap("bench.readplane.rank", rank))
        patch(FtsStore, "search_exact", exact)
        patch(FtsStore, "search", host_search)
        patch(service.backend.encoder, "encode", enc)

    def restore(self) -> None:
        for owner, name, old, own in reversed(self.undo):
            if own:
                setattr(owner, name, old)
            else:
                delattr(owner, name)


def run(ctx) -> Outcome:
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.index.manager import SharedStores
    from codesearch_tpu_torch.server.readplane import ranked_chunks

    cfg, dims, dev = ctx.cell.config, ctx.cell.dims, ctx.device
    corpus_p, qp = ctx.cell.traffic["corpus"], ctx.cell.traffic["queries"]
    n = int(corpus_p["chunks"])
    with ctx.phase("weights"):
        install_weights(ctx)
    with ctx.phase("texts"):
        chunks = make_chunks(corpus_p, ctx.seed, n, workers=workers(n))
    with ctx.phase("service"):
        service = EmbeddingService(cfg["registry_model"], use_persistent_cache=False, device=dev)
    check_served_model(service.spec, ctx.home, cfg, dims)
    spread = float(corpus_p["cluster_spread"])
    with ctx.phase("vectors"):
        vecs = corpus_vectors(chunks.group, dims["hidden"], spread, ctx.seed, dev)
        stores = SharedStores(ctx.work / "db", service.dims, readonly=False, device=dev)
    build(ctx, chunks, vecs, stores)
    del vecs
    metadata = {"primary_language": chunks.primary_language}

    n_warm = int(qp["warmup"])
    count = max(int(qp["min_count"]), math.ceil(float(qp["ceiling_per_s"]) * ctx.seconds))
    with ctx.phase("queries"):
        allq = make_queries(ctx.seed, chunks.writer.words, chunks.writer.weights.tolist(),
                            chunks.names, count + n_warm, qp["mix"],
                            tuple(qp["question_words"]))
    warm, queries = allq[:n_warm], allq[n_warm:]

    cap = Capture(ctx, service)
    with ctx.phase("warm-up"):
        for q in warm:
            with stores.lock:
                ranked_chunks(stores, service, metadata, q, limit=LIMIT)
        sync(dev)
    with ctx.phase("flush"):       # the index written in set-up reaches the disk
        os.sync()                  # before the window, not during it
    setup_s = time.perf_counter() - ctx.t_start

    # what each query produced is kept only for a seeded sample of the
    # first SAMPLE_FROM queries and for the longest query so far, so that
    # the harness's own memory does not grow over the window
    rnd = random.Random(ctx.seed)
    n_check = int(ctx.cell.traffic["check"]["sample"])
    keep = set(rnd.sample(range(min(SAMPLE_FROM, len(queries))), n_check - 1))
    kept, longest, lat, failed = [], None, [], 0
    win = Window(ctx.seconds, ctx)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # a traced run profiles the window's first trace_seconds only: the
    # profiler's record of every query's host operations takes minutes to
    # read back for a whole window
    trace_s = min(ctx.seconds, float(qp["trace_seconds"]))
    traced = 0
    with ctx.tracer.window():
        t0_ns = t1_ns = time.time_ns()
        win.open()
        i = 0
        while win.due():
            if ctx.tracer.enabled and time.perf_counter() - win.t0 >= trace_s:
                t1_ns, traced = time.time_ns(), i
                ctx.tracer.stop()
            q = queries[i % len(queries)]
            cap.rec = rec = {"q": q}
            t = time.perf_counter()
            try:
                with stores.lock, ctx.tracer.span("bench.query"):
                    hits = ranked_chunks(stores, service, metadata, q, limit=LIMIT)
                lat.append((time.perf_counter() - t) * 1e3)
                rec["hits"] = [(s, cid) for s, cid, _m in hits]
                if i in keep:
                    kept.append(rec)
                elif longest is None or len(q) > len(longest["q"]):
                    longest = rec
            except Exception:  # a failed query counts as missing
                lat.append(float("inf"))
                failed += 1
            i += 1
        window_s = win.close()
        if ctx.tracer.enabled:
            t1_ns, traced = time.time_ns(), i
    cap.restore()
    peak = memory_peak(dev)
    attempted = len(lat)
    e2e = {"setup_s": setup_s, "query_p95_ms": percentile(lat, 95),
           "queries_per_s": (attempted - failed) / window_s}

    trace = {}
    if ctx.trace:
        from ..trace import reduce

        trace = reduce(ctx.tracer.prof, t0_ns, t1_ns)
        ctx.tracer.prof = None
        trace.update(queries=traced,
                     spans={k: (ctx.tracer.totals[k], ctx.tracer.counts[k])
                            for k in ctx.tracer.totals})
    del stores, service
    free_device(dev)

    sample = kept + ([longest] if longest is not None else [])
    if sample and ctx.control:
        control_records(ctx, chunks, sample, metadata)
    if sample:
        checks = judge(ctx, chunks, sample, metadata)
    else:                           # nothing came back to judge
        checks = [(name, 1, lim) for name, lim in ctx.cell.limits.items()]
    if ctx.trace:
        trace.update(query_work(ctx, chunks, [queries[j % len(queries)]
                                              for j in range(traced)]))
    return Outcome(e2e=e2e, attempted=attempted, failed=failed, checks=checks, trace=trace,
                   memory_peak_bytes=peak)


def _pairs(results) -> list:
    return [(r.chunk_id, r.score) for r in (results or [])]


class Hit(NamedTuple):
    """A candidate as the control lists it, read as the program's are."""
    chunk_id: int
    score: float


def control_records(ctx, chunks, sample, metadata) -> None:
    """Puts the control in the program's place in each sampled record: the
    reference encoder's query vector in float8 (e4m3, a scale a row), the
    vector leg scored with query and corpus rows in float8, the BM25 and
    exact-identifier legs scored in bfloat16, and the ranked list the
    reference's ranking of those lists."""
    low_q = reference_queries(ctx, sample, quant="fp8")
    low = exact_scores(ctx, chunks, low_q, quant="fp8")
    corpus = reference_corpus(chunks, sample)

    def top(scores, k):
        idx = np.argsort(-scores, kind="stable")[:k]
        return [Hit(int(c), float(scores[c])) for c in idx if scores[c] > 0]

    def chunk_of(cid):
        return chunks.path[cid], chunks.kind[cid], chunks.language[cid], chunks.content[cid]

    for i, r in enumerate(sample):
        q = r["q"]
        kind = ranking.structural_kind(q)
        fetch = ranking.serving_fetch(q, LIMIT)
        r["qvec"] = low_q[i][None]
        r["vres"] = [Hit(int(c), float(low[i][c]))
                     for c in np.argsort(-low[i], kind="stable")[:fetch]]
        r["fres"] = top(corpus.bm25(ranking.bm25_text(q), kind, bf16), fetch)
        r["eres"] = [top(corpus.exact(ident, kind, bf16), fetch)
                     for ident in ranking.detect_identifiers(q)]
        r["hits"] = ranking.rank(q, LIMIT, _pairs(r["vres"]), _pairs(r["fres"]),
                                 [p for got in r["eres"] for p in _pairs(got)], chunk_of,
                                 metadata["primary_language"])


def reference_queries(ctx, sample, quant: str | None = None) -> torch.Tensor:
    """The reference encoder's vectors [S, hidden] of the sampled queries."""
    dims, cfg = ctx.cell.dims, ctx.cell.config
    enc = Encoder(dims, reference_weights(ctx), ctx.device, quant=quant)
    texts = [cfg["query_prefix"] + (ranking.parse_operators(r["q"])[0] or r["q"])
             for r in sample]
    return encode_texts(enc, [token_ids(t, dims["vocab"], dims["positions"]) for t in texts])


def exact_scores(ctx, chunks, queries: torch.Tensor, quant: str | None = None) -> np.ndarray:
    """[S, N] scores of ``queries`` against the corpus vectors (remade from
    the seed): exact in float32, or both sides rounded as ``quant`` says."""
    dev = ctx.device
    vecs = corpus_vectors(chunks.group, ctx.cell.dims["hidden"],
                          float(ctx.cell.traffic["corpus"]["cluster_spread"]), ctx.seed, dev)
    q = queries.to(dev).float()
    if quant == "fp8":
        q, vecs = fp8_round(q), fp8_round(vecs)
    with exact_float32():
        return (q @ vecs.T).cpu().numpy()


def reference_corpus(chunks, sample) -> Corpus:
    """The reference's statistics for the BM25 terms and exact targets of
    the sampled queries."""
    terms = set()
    for r in sample:
        terms.update(query_terms(ranking.bm25_text(r["q"])))
        for ident in ranking.detect_identifiers(r["q"]):
            t = exact_target(ident)
            if t:
                terms.add(t)
    return Corpus(chunks.content, chunks.path, chunks.signature, chunks.kind, sorted(terms),
                  workers=workers(len(chunks)))


def judge(ctx, chunks, sample, metadata) -> list:
    """The check's numbers over the sample. The query vector is held to the
    reference encoder's; the vector leg to exact scores of the program's own
    query vector (so it judges the top-k stage by itself); the BM25 and
    exact legs to the reference's scores; the ranked list to the reference's
    ranking arithmetic over the program's own candidate lists."""
    ref_q = reference_queries(ctx, sample)
    prog_q = torch.stack([r["qvec"].float().cpu()[0] for r in sample])
    cos = exact_scores(ctx, chunks, prog_q)
    corpus = reference_corpus(chunks, sample)

    def chunk_of(cid):
        return chunks.path[cid], chunks.kind[cid], chunks.language[cid], chunks.content[cid]

    worst = {"query_vector": 0.0, "vector_leg": 0.0, "bm25_leg": 0.0, "exact_leg": 0.0,
             "ranked_list": 0}
    for i, r in enumerate(sample):
        q = r["q"]
        kind = ranking.structural_kind(q)
        fetch = ranking.serving_fetch(q, LIMIT)
        cos_q = float(torch.nn.functional.cosine_similarity(prog_q[i], ref_q[i], dim=0))
        worst["query_vector"] = max(worst["query_vector"], 1.0 - cos_q if cos_q == cos_q else 1.0)
        worst["vector_leg"] = max(worst["vector_leg"],
                                  list_gap(_pairs(r["vres"]), cos[i], fetch, 1.0))
        fres = r["fres"] if r["fres"] is not None else r.get("fres_host", [])
        bm = corpus.bm25(ranking.bm25_text(q), kind)
        worst["bm25_leg"] = max(worst["bm25_leg"],
                                list_gap(_pairs(fres), bm, fetch, positive_only=True))
        eres = r.get("eres", [])
        for ident, got in zip(ranking.detect_identifiers(q), eres):
            ex = corpus.exact(ident, kind)
            worst["exact_leg"] = max(worst["exact_leg"],
                                     list_gap(_pairs(got), ex, fetch, positive_only=True))
        want = ranking.rank(q, LIMIT, _pairs(r["vres"]), _pairs(fres),
                            [p for got in eres for p in _pairs(got)], chunk_of,
                            metadata["primary_language"])
        worst["ranked_list"] += ranked_mismatch(r["hits"], want)
    lim = ctx.cell.limits
    return [(name, value, lim.get(name)) for name, value in worst.items()]


def query_work(ctx, chunks, queries) -> dict:
    """Counts for the per-layer readers, from the benchmark's own inputs:
    each query's real tokens and the postings its BM25 terms select."""
    dims, cfg = ctx.cell.dims, ctx.cell.config
    lens = [len(token_ids(cfg["query_prefix"] + (ranking.parse_operators(q)[0] or q),
                          dims["vocab"], dims["positions"])) for q in queries]
    terms = sorted({t for q in queries for t in query_terms(ranking.bm25_text(q))})
    corpus = Corpus(chunks.content, chunks.path, chunks.signature, chunks.kind, terms,
                    workers=workers(len(chunks)))
    postings = [corpus.scanned_postings(ranking.bm25_text(q)) for q in queries]
    return {"query_tokens": lens, "posting_bytes": [p * POSTING_BYTES for p in postings],
            "corpus_rows": len(chunks), "dims": dims, "weight_bytes": weight_bytes(dims),
            "top_k": ranking.serving_fetch("", LIMIT)}
