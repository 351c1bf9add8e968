#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codesearch_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
device and the package beside this file, and exits non-zero otherwise or
when any phase fails:

1. environment: torch/CUDA versions, the card's name and power limit,
   whether msgpack and the native host tier load;
2. builds the top-k kernels from ``codesearch_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version at the main path's
   shapes (Q in {1, 9} query variants, N=262,144 rows, d=384, k in {10,
   200, 500}, and at Q=9 also k=1024 and the bound k=4096, where the merge
   runs in two levels; B in {1, 8} score rows for the selection kernel),
   with exact ties and invalid rows, checks that k above the bound raises,
   and times both with CUDA events;
4. indexes the repository's own ``codesearch_tpu/`` sources with the port
   and searches that index through the port's CLI (``--json``);
5. builds a 262,144-chunk synthetic index through the port's write plane
   (code-hash-384, bf16), answers hybrid, vector-only and identifier
   queries through a port ``SearchSession`` on the GPU, checks the answers
   against the same session on the CPU (plain versions), counts kernel
   launches, then repeats a short pass on the int8 corpus.

It prints one JSON line of per-kernel results, the ``nvidia-smi`` name and
power-limit line, and last the result line the harness reads.
"""

from __future__ import annotations

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
KERNEL_SOURCE = "codesearch_tpu_torch/csrc/topk_kernels.cu"
REPLACES = {
    "fused_cosine_topk": "codesearch_tpu/ops/pallas_topk.py:244",
    "fused_cosine_topk_int8": "codesearch_tpu/ops/pallas_topk.py:201",
    "fused_scores_topk": "codesearch_tpu/ops/pallas_topk.py:164",
}
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


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
    return out


# ---------------------------------------------------------------------------
# phase 4: the repository's own sources through index() and the CLI
# ---------------------------------------------------------------------------

def repo_index_and_cli(work: Path, device: str) -> None:
    from codesearch_tpu_torch.index import IndexOptions, index

    db = work / "self-db"
    t0 = time.perf_counter()
    stats = index(ROOT / "codesearch_tpu", IndexOptions(store_path=db, quiet=True),
                  device=device)
    log(f"index codesearch_tpu/: {stats.files_indexed} files, {stats.chunks_added} "
        f"chunks in {time.perf_counter() - t0:.2f} s")
    check(stats.chunks_added > 100, "indexing the repository's sources found too few chunks")
    cmd = [sys.executable, "-m", "codesearch_tpu_torch.cli", "--store", str(db),
           *(["--platform", "cpu"] if device == "cpu" else []),
           "search", "exact cosine top-k over the corpus", str(ROOT / "codesearch_tpu"),
           "--json", "--limit", "5"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env=os.environ.copy())
    check(proc.returncode == 0, f"CLI search failed ({proc.returncode}): {proc.stderr[-2000:]}")
    resp = json.loads(proc.stdout)
    hits = resp["results"]
    log(f"CLI search --json in {time.perf_counter() - t0:.2f} s: {len(hits)} hits, top "
        f"{hits[0]['path'] if hits else None}")
    check(len(hits) == 5 and all(h["path"].endswith(".py") for h in hits),
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


def build_synthetic(db: Path, n_rows: int, device: str) -> dict:
    """bench.py's synthetic corpus through the port's write plane, with an
    identifier in every third chunk (df ~ n/3: above the 65,536 plane floor
    and below the 0.4 n stopword cap at n = 262,144)."""
    from codesearch_tpu_torch.embed import Chunk, ChunkKind, EmbeddingService
    from codesearch_tpu_torch.fts import FtsStore
    from codesearch_tpu_torch.index import IndexStats, write_metadata
    from codesearch_tpu_torch.vectordb import ChunkMetadata, VectorStore

    svc = EmbeddingService("code-hash-384", use_persistent_cache=False, device=device)
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
    return {"seconds": total, "chunks_per_s": n_rows / total,
            "phases_s": ph}


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
        from codesearch_tpu_torch.models.hash_embedder import _native_lib
        from codesearch_tpu_torch.ops import _build
        from codesearch_tpu_torch.ops import fused_topk as ft

        try:
            import msgpack  # noqa: F401
            has_msgpack = True
        except ImportError:
            has_msgpack = False
        log(f"msgpack importable: {has_msgpack}; native host tier (g++) loaded: "
            f"{_native_lib() is not None}")
        t = time.perf_counter()
        _build.load(verbose=True)
        log(f"kernel build + load {time.perf_counter() - t:.2f} s "
            f"(nvcc {_build.build_log['seconds']:.2f} s) -> {_build.build_log['path']}")
        for line in _build.build_log["output"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  " + line.strip())
        timing = kernel_checks("cuda")
        repo_index_and_cli(work, "cuda")
        synth = synthetic_session(work, N_ROWS, "cuda", cpu_check=True)
        kernels = []
        for name, route_launches in (("fused_cosine_topk", synth["bf16"]["launches"]),
                                     ("fused_cosine_topk_int8", synth["int8"]["launches"]),
                                     ("fused_scores_topk", synth["bf16"]["launches"])):
            kernels.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                            "replaces": REPLACES[name], "launches": route_launches[name],
                            **timing[name]})
        check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
        check("jax" not in sys.modules, "jax was imported")
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
