"""Fresh repositories indexed one after another through the program's
entry point: ``index.pipeline.index(repo, IndexOptions(model, force=True,
quiet=True), device="cuda")``, which walks, chunks, tokenizes, encodes and
stores.

Set-up writes the seeded weights, then indexes a small repository of its
own to warm the path. The window is the index calls' own time: before each
call the next seeded repository is written (files in Python, Rust,
TypeScript and Go; every definition's name unique within the run, so no
call finds another's chunks in the embedding cache), off the clock; a call
starts while the calls so far have taken less than ``--seconds``, and the
last one finishes. So no pool of repositories bounds the window, however
fast the program gets. Afterwards each completed call's stores are
counted, and a seeded sample of calls is held to what the generator wrote
and to the reference: every stored chunk is a slice of its file, every
definition is covered, and a sample of stored vectors, the longest chunks
among them, is compared with the reference encoder's vectors of the same
texts. With ``ctx.control`` the reference a precision lower (fp8) takes the
stored vectors' place in that comparison.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from ..gen.code import CodeWriter, corpus_shape
from ..reference.encoder import Encoder, encode_texts
from ..reference.textstats import token_counts
from ..reference.tokenizer import ENCODER_MAX_TOKENS, chunk_text, token_ids
from .common import (CallClock, Outcome, check_served_model, free_device, install_weights,
                     memory_peak, reference_weights, sync)


SPLIT_HEADER = "// [Part "    # the first line of each part of a split definition


def write_repo(root, files) -> None:
    (root / ".git").mkdir(parents=True)
    for f in files:
        p = root / f.path
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(f.text())


class Repos:
    """The run's seeded repositories, written one at a time under
    ``ctx.work``."""

    def __init__(self, ctx, p: dict):
        self.work = ctx.work
        self.writer = CodeWriter(ctx.seed, p)
        self.shape = corpus_shape(p, int(p["functions"]))
        self.warm_shape = corpus_shape(p, int(p["warmup_functions"]))
        self.n = 0

    def warm(self):
        files = self.writer.files(self.warm_shape, "warm/")
        write_repo(self.work / "warm", files)
        return self.work / "warm"

    def next(self):
        """(path, files) of a new repository."""
        files = self.writer.files(self.shape, f"{self.writer.ident('snake', 1, 2)}/")
        root = self.work / f"repo_{self.n}"
        self.n += 1
        write_repo(root, files)
        return root, files


class Spans:
    """Class-level wraps of the embedding service and the stores: spans
    (traced runs) and the services built, whose counters the readers read."""

    def __init__(self, ctx):
        from codesearch_tpu_torch.embed import EmbeddingService
        from codesearch_tpu_torch.fts.store import FtsStore
        from codesearch_tpu_torch.vectordb import VectorStore

        self.services = []
        self.undo = []
        tr = ctx.tracer
        embed = EmbeddingService.embed_chunks_matrix_async
        spans = self

        def embed_async(service, chunks):
            spans.services.append(service)
            with tr.span("bench.index.embed"):
                finish = embed(service, chunks)
            return tr.wrap("bench.index.embed_wait", finish)

        self._patch(EmbeddingService, "embed_chunks_matrix_async", embed_async)
        for owner, names in ((VectorStore, ("insert_chunks_with_ids", "build_index", "save")),
                             (FtsStore, ("add_chunks", "commit"))):
            for name in names:
                self._patch(owner, name, tr.wrap("bench.index.store", getattr(owner, name)))

    def _patch(self, owner, name, new):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def restore(self) -> None:
        for owner, name, old in reversed(self.undo):
            setattr(owner, name, old)


def run(ctx) -> Outcome:
    from codesearch_tpu_torch.index import IndexOptions
    from codesearch_tpu_torch.index.pipeline import index
    from codesearch_tpu_torch.models import parse_model

    cfg, dims, dev = ctx.cell.config, ctx.cell.dims, ctx.device
    p = ctx.cell.traffic["repositories"]
    with ctx.phase("weights"):
        install_weights(ctx)
    repos = Repos(ctx, p)
    with ctx.phase("repositories"):
        warm = repos.warm()
    opts = IndexOptions(model=cfg["registry_model"], force=True, quiet=True)
    check_served_model(parse_model(cfg["registry_model"]), ctx.home, cfg, dims)
    with ctx.phase("warm-up"):
        index(warm, opts, device=dev.type)
        sync(dev)
    free_device(dev)
    setup_s = time.perf_counter() - ctx.t_start

    spans = Spans(ctx) if ctx.trace else None
    calls, failed = [], 0
    clock = CallClock(ctx.seconds, ctx)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with ctx.tracer.window():
        clock.open()
        while clock.due():
            repo, files = repos.next()
            with clock.timed():
                try:
                    st = index(repo, opts, device=dev.type)
                except Exception as e:  # a failed call stores nothing that counts
                    st = e
            s = (clock.intervals[-1][1] - clock.intervals[-1][0]) / 1e9
            if isinstance(st, Exception):
                failed += 1
                calls.append({"repo": repo, "error": repr(st), "s": s})
            else:
                calls.append({"repo": repo, "files": files, "chunks": st.chunks_added,
                              "db": st.db_path, "s": s})
        window_s = clock.close()
    peak = memory_peak(dev)
    done = [c for c in calls if "error" not in c]
    e2e = {"setup_s": setup_s,
           "index_chunks_per_s": sum(c["chunks"] for c in done) / window_s}
    trace = {}
    if spans is not None:
        spans.restore()
        from ..trace import reduce

        trace = reduce(ctx.tracer.prof, intervals=clock.intervals)
        ctx.tracer.prof = None
        counts = [s.backend.counts for s in spans.services if hasattr(s.backend, "counts")]
        trace.update(index_calls=len(calls),
                     index_wall_s=sum(c["s"] for c in done), dims=dims,
                     tokens=sum(c["tokens"] for c in counts),
                     padded_tokens=sum(c["padded_tokens"] for c in counts),
                     spans={k: (ctx.tracer.totals[k], ctx.tracer.counts[k])
                            for k in ctx.tracer.totals})
        del spans
    free_device(dev)

    checks = judge(ctx, done)
    if ctx.trace:
        trace["text_tokens"] = stored_token_lengths(ctx, done)
    return Outcome(e2e=e2e, attempted=len(calls), failed=failed, checks=checks, trace=trace,
                   memory_peak_bytes=peak)


def open_stores(db, dims: int):
    from codesearch_tpu_torch.fts import FtsStore
    from codesearch_tpu_torch.index.file_meta import FileMetaStore
    from codesearch_tpu_torch.vectordb import VectorStore

    store = VectorStore(db, dims=dims, readonly=True, device="cpu")
    fts = FtsStore(db / "fts", readonly=True, device="cpu")
    manifest = FileMetaStore.load_or_create(db)
    return store, fts, manifest


def stored_vector(store, cid: int) -> np.ndarray:
    """The row the store holds for ``cid``, as the store wrote it (fp16)."""
    row = store._current_row(cid)
    return np.asarray(store._rows_range(row, row + 1)[0], np.float32)


def stored_chunks(db, dims: int):
    store, _fts, _m = open_stores(db, dims)
    return store, list(store.iter_chunks())


def chunk_set_faults(c, store, metas, fts, manifest) -> int:
    """Faults of one call's chunk set: counts that disagree (the call's
    own, the vector store's, the full-text store's, the manifest's), a
    stored chunk that is not the slice of its file it claims, a
    definition no stored chunk covers."""
    n_manifest = sum(len(f.chunk_ids) for f in manifest.files.values())
    faults = int(len({c["chunks"], len(store), len(fts), n_manifest, len(metas)}) != 1)
    faults += int(c["chunks"] == 0)
    lines = {f.path: f.text().split("\n") for f in c["files"]}
    covered = {path: np.zeros(len(ls) + 1, bool) for path, ls in lines.items()}
    for _cid, m in metas:
        src = lines.get(m.path)
        content = m.content
        if content.startswith(SPLIT_HEADER):      # a part of a long definition
            content = content.split("\n", 1)[1]
        piece = "\n".join(src[m.start_line:m.end_line]) if src is not None else None
        # a nested definition's chunk starts at its own column
        if piece is None or content not in (piece, piece.lstrip(" \t")):
            faults += 1
            continue
        covered[m.path][m.start_line:m.end_line] = True
    for f in c["files"]:
        at = len(f.header)
        for u in f.units:
            sig = next(i for i, ln in enumerate(u.lines) if ln.strip() == u.signature)
            faults += int(not covered[f.path][at + sig])
            at += len(u.lines) + 1
    return faults


def judge(ctx, done) -> list:
    dims = ctx.cell.dims
    p = ctx.cell.traffic["check"]
    rnd = random.Random(ctx.seed)
    lim = ctx.cell.limits
    if not done:
        return [("chunk_set", 1, lim.get("chunk_set")),
                ("stored_vectors", 1.0, lim.get("stored_vectors"))]
    sample = [done[-1]] + rnd.sample(done[:-1], min(len(done) - 1, int(p["repositories"]) - 1))
    faults = 0
    for c in done:
        store, fts, manifest = open_stores(c["db"], dims["hidden"])
        metas = list(store.iter_chunks()) if any(c is s for s in sample) else None
        if metas is None:
            n_manifest = sum(len(f.chunk_ids) for f in manifest.files.values())
            faults += int(len({c["chunks"], len(store), len(fts), n_manifest}) != 1)
            continue
        faults += chunk_set_faults(c, store, metas, fts, manifest)
    rows, got = [], []
    for c in sample:
        store, metas = stored_chunks(c["db"], dims["hidden"])
        texts = [chunk_text(m.content, m.context, m.signature, m.docstring) for _cid, m in metas]
        ids = [token_ids(t, dims["vocab"], dims["positions"]) for t in texts]
        order = sorted(range(len(ids)), key=lambda i: -len(ids[i]))
        n_long = int(p["longest"])
        rest = order[n_long:]
        pick = order[:n_long] + rnd.sample(rest, max(0, min(len(rest), int(p["chunks"]) - n_long)))
        for i in pick:
            rows.append(ids[i])
            got.append(stored_vector(store, metas[i][0]))
    if not rows:                  # nothing stored to compare
        return [("chunk_set", max(faults, 1), lim.get("chunk_set")),
                ("stored_vectors", 1.0, lim.get("stored_vectors"))]
    weights = reference_weights(ctx)
    want = encode_texts(Encoder(dims, weights, ctx.device), rows).numpy()
    if ctx.control:               # the control's vectors in place of the stored ones
        got = encode_texts(Encoder(dims, weights, ctx.device, quant="fp8"), rows).numpy()
    del weights
    free_device(ctx.device)
    got = np.stack(got)
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    return [("chunk_set", faults, lim.get("chunk_set")),
            ("stored_vectors", float(np.nan_to_num(1.0 - cos, nan=1.0).max()),
             lim.get("stored_vectors"))]


def stored_token_lengths(ctx, done) -> list[int]:
    """Real tokens of every chunk the window's calls embedded (frozen
    tokenizer over the stored chunks' texts)."""
    dims = ctx.cell.dims
    texts = []
    for c in done:
        _store, metas = stored_chunks(c["db"], dims["hidden"])
        texts += [chunk_text(m.content, m.context, m.signature, m.docstring) for _c, m in metas]
    n = token_counts(texts)
    return (np.minimum(np.minimum(n, dims["positions"] - 2) + 2, ENCODER_MAX_TOKENS)).tolist()
