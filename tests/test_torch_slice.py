"""The ported slice as a whole: index -> hybrid search, JAX against torch.

Both packages read and write one on-disk index. A corpus of the small
demo repository plus ~3,000 synthetic chunks is indexed by one package and
searched by both, with the device routes forced (no small-corpus host
shortcut, device BM25 from the first document, a low score-plane floor so
the dense leg runs). Hits must come back with the same chunk ids in the
same order; scores agree within 1e-5 (the vector leg's f32 sums run in
another order). The port runs on ``device="cpu"``, i.e. its plain
versions; the hash table is the JAX package's (the port's table cache is
seeded from ``make_table(384)``, which it equals bit for bit).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from codesearch_tpu.index.pipeline import IndexOptions as JaxIndexOptions
from codesearch_tpu.index.pipeline import index as jax_index
from codesearch_tpu.models.hash_embedder import make_table as jax_make_table
from codesearch_tpu.search.pipeline import SearchSession as JaxSession
from codesearch_tpu_torch.index import IndexOptions, index
from codesearch_tpu_torch.models import hash_embedder as th
from codesearch_tpu_torch.ops import fused_topk
from codesearch_tpu_torch.search import SearchOptions, SearchSession
from codesearch_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-5
VERBS = ["parse", "walk", "render", "compute", "merge", "flush", "encode",
         "resolve", "validate", "dispatch"]
NOUNS = ["config", "tree", "buffer", "index", "token", "matrix", "query",
         "chunk", "socket", "schema"]
QUERIES = [
    ("validate the schema and return it", "hybrid"),
    ("parse the configuration file", "hybrid"),
    ("shared_registry sync", "hybrid"),
    ("where is shared_registry used", "hybrid"),
    ("merge token buffer", "vector"),
    ("compute matrix", "vector"),
    ("content hash of bytes", "hybrid"),
]


@pytest.fixture(autouse=True)
def port_table_from_jax():
    """Seed the port's table cache with the JAX package's table."""
    path = th._table_bits_path(384, th.VOCAB_BUCKETS)
    if not path.exists():
        np.asarray(jax_make_table(384)).view(np.uint16).ravel().tofile(path)


def _add_synthetic(repo: Path, n_files: int = 30, per_file: int = 100) -> None:
    for f in range(n_files):
        lines = []
        for j in range(per_file):
            i = f * per_file + j
            v, o = VERBS[i % 10], NOUNS[(i // 10) % 10]
            extra = "    shared_registry.sync(arg)\n" if i % 3 == 0 else ""
            lines.append(f"def {v}_{o}_{i}(arg):\n"
                         f'    """{v.capitalize()} the {o} number {i}."""\n'
                         f"{extra}    return arg.{o} + {i}\n")
        (repo / "src" / f"gen_{f}.py").write_text("\n\n".join(lines))


def _force_device_routes(session) -> None:
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    session.fts.plane_df_floor = 300


def _hits(session, query, mode):
    resp = session.search(query, SearchOptions(limit=10, mode=mode))
    return [h.chunk_id for h in resp.hits], np.array([h.score for h in resp.hits])


def _assert_same_results(db: Path):
    js = JaxSession(db)
    ts = SearchSession(db, device="cpu")
    _force_device_routes(js)
    _force_device_routes(ts)
    fused_topk.reset_launch_counts()
    for query, mode in QUERIES:
        jids, jscores = _hits(js, query, mode)
        tids, tscores = _hits(ts, query, mode)
        assert jids, f"no hits for {query!r}"
        assert tids == jids, query
        np.testing.assert_allclose(tscores, jscores, rtol=0, atol=SCORE_TOL)
    # the dense BM25 leg (score planes) ran in both sessions
    assert ts.fts.plane_builds > 0 and js.fts.plane_builds > 0
    # on the CPU the kernel wrappers took their plain versions
    assert all(n == 0 for n in fused_topk.launch_counts.values())
    assert ts.store._device[1].device.type == "cpu"


def test_jax_index_port_search(tmp_repo, tmp_path):
    _add_synthetic(tmp_repo)
    db = tmp_path / "db"
    stats = jax_index(tmp_repo, JaxIndexOptions(store_path=db))
    assert stats.chunks_added > 3000
    _assert_same_results(db)


def test_port_index_jax_search(tmp_repo, tmp_path):
    _add_synthetic(tmp_repo)
    db = tmp_path / "db"
    stats = index(tmp_repo, IndexOptions(store_path=db), device="cpu")
    assert stats.chunks_added > 3000
    _assert_same_results(db)


def test_port_int8_index_matches_jax(tmp_repo, tmp_path):
    _add_synthetic(tmp_repo, n_files=10)
    db = tmp_path / "db"
    index(tmp_repo, IndexOptions(store_path=db, int8=True), device="cpu")
    js, ts = JaxSession(db), SearchSession(db, device="cpu")
    for s in (js, ts):
        s.store.host_path_rows = 0
    assert ts.store.int8 and js.store.int8
    for query in ("validate the schema and return it", "compute matrix"):
        jids, jscores = _hits(js, query, "vector")
        tids, tscores = _hits(ts, query, "vector")
        assert tids == jids
        np.testing.assert_allclose(tscores, jscores, rtol=0, atol=SCORE_TOL)


_NO_JAX_SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "codesearch_tpu"):
                raise ImportError(name + " is blocked")
            return None

    if sys.argv[3] == "block":
        sys.meta_path.insert(0, _Block())
    import codesearch_tpu_torch
    for m in pkgutil.walk_packages(codesearch_tpu_torch.__path__, "codesearch_tpu_torch."):
        if not m.name.endswith("__main__"):
            importlib.import_module(m.name)
    from codesearch_tpu_torch.index import IndexOptions, index
    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    repo, db = sys.argv[1], sys.argv[2]
    stats = index(repo, IndexOptions(store_path=db), device="cpu")
    session = SearchSession(db, device="cpu")
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    resp = session.search("parse the configuration file", SearchOptions(limit=5))
    assert resp.hits and resp.hits[0].path.endswith("main.py"), resp.hits
    # the BERT-family backend (tokenizer, numpy init, encoder, attention) too
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.models.registry import ArchConfig, ModelSpec

    tiny = ModelSpec("tiny-bert", "test/tiny-bert", 64, "bert", arch=ArchConfig(
        vocab_size=2048, hidden=64, layers=2, heads=2, intermediate=128, max_len=64))
    svc = EmbeddingService(tiny, use_persistent_cache=False, device="cpu")
    assert svc.fused_kind() == "bert"
    assert svc.backend.embed(["def parse(path): return path"]).shape == (1, 64)
    blocked = [m for m in ("jax", "jaxlib", "ml_dtypes", "codesearch_tpu") if m in sys.modules]
    assert not blocked, blocked
    print("OK", stats.chunks_added, len(resp.hits))
""")


def _run_port_alone(tmp_repo, tmp_path, jax_import: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, str(tmp_repo), str(tmp_path / "db"), jax_import],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_with_jax_absent(tmp_repo, tmp_path):
    _run_port_alone(tmp_repo, tmp_path, "block")


def test_port_leaves_installed_jax_unimported(tmp_repo, tmp_path):
    # jax and the JAX package are importable here; the port must still load
    # neither
    _run_port_alone(tmp_repo, tmp_path, "allow")


def test_resolve_device_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_gpu_session_bounds_fetch(tmp_repo, tmp_path):
    # the GPU kernels select at most MAX_K rows; a GPU session refuses a
    # limit whose candidate depth could exceed that, before any device work
    from codesearch_tpu_torch.search.pipeline import MAX_FETCH
    from codesearch_tpu_torch.utils.errors import SearchError

    db = tmp_path / "db"
    index(tmp_repo, IndexOptions(store_path=db, quiet=True), device="cpu")
    session = SearchSession(db, device="cpu")
    assert session._prep_query("parse the file", SearchOptions(limit=410))["fetch"] > MAX_FETCH
    session.device = torch.device("cuda")
    assert session._prep_query("parse the file", SearchOptions(limit=409))["fetch"] <= MAX_FETCH
    with pytest.raises(SearchError, match="at most 2048"):
        session._prep_query("parse the file", SearchOptions(limit=410))
    with pytest.raises(SearchError):
        session._prep_query("parse the file", SearchOptions(limit=683, mode="vector"))


def test_port_refuses_bert_models(tmp_path):
    # BERT encoders with absolute positions run (tests/test_torch_bert_slice.py);
    # the rotary and ALiBi families are refused, not substituted
    from codesearch_tpu_torch.embed import EmbeddingService

    for model in ("nomic-v1.5", "modernbert-large"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            EmbeddingService(model, device="cpu")


def test_cli_index_and_search_json(tmp_repo, tmp_path):
    from codesearch_tpu_torch.cli import main

    db = tmp_path / "db"
    assert main(["--platform", "cpu", "--quiet", "--store", str(db), "index", str(tmp_repo)]) == 0
    assert main(["--platform", "cpu", "mcp"]) == 2
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "codesearch_tpu_torch.cli", "--platform", "cpu", "--store",
         str(db), "search", "compute a content hash", str(tmp_repo), "--json"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    hits = json.loads(proc.stdout)["results"]
    assert hits and hits[0]["path"].endswith("lib.rs")
