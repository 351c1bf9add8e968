"""The BERT-family slice as a whole: bge-small index -> hybrid search, JAX
against torch, on the CPU.

A small repository of short functions (token buckets of at most 128) is
indexed with bge-small by each package; both use the JAX package's random
init (the port's init cache is seeded from ``init_params(PRNGKey(0))``,
which its numpy init equals bit for bit, ``tests/test_torch_encoder.py``).
Then each package searches both indexes with the device routes forced:

- the stored rows of the two indexes agree (cosine >= 0.999 per chunk);
- the BM25 legs of the fused hybrid call are identical (same chunk ids in
  the same order, scores within 1e-5);
- the vector legs agree within the embedding tolerance: the two packages'
  query embeddings differ by bf16 rounding (cosine about 0.99997), which
  moved ranked scores by up to 3.5e-4 here; they must agree within 1e-3,
  and the chunk the port ranks at each position must score within 2e-3 of
  JAX's score at that position by JAX's own query vector. Random-init
  embeddings are nearly collapsed (all 48 chunks score within about 6e-3 of
  each other), so most positions are near-ties and their order differs.
"""

import numpy as np
import pytest
import torch

from codesearch_tpu.index.pipeline import IndexOptions as JaxIndexOptions
from codesearch_tpu.index.pipeline import index as jax_index
from codesearch_tpu.models.encoder import init_params as jax_init_params
from codesearch_tpu.models.registry import MODELS
from codesearch_tpu.search.pipeline import SearchSession as JaxSession
from codesearch_tpu.vectordb.store import VectorStore as JaxVectorStore
from codesearch_tpu_torch.embed.service import _BertBackend
from codesearch_tpu_torch.index import IndexOptions, index
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.ops import attention, fused_topk
from codesearch_tpu_torch.search import SearchOptions, SearchSession
from codesearch_tpu_torch.utils.device import to_host

MODEL = "bge-small"
ROW_COS_MIN = 0.999
SCORE_TOL = 1e-3
BM25_TOL = 1e-5
VERBS = ["parse", "render", "merge", "flush", "encode", "resolve", "validate", "scan"]
NOUNS = ["config", "buffer", "token", "matrix", "socket", "schema"]
QUERIES = [("validate the schema", "hybrid"), ("flush the socket buffer", "hybrid"),
           ("merge token matrix", "vector")]


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """One small repository indexed by each package: (repo, jax db, port db)."""
    import jax

    cfg = MODELS[MODEL].arch
    te.save_params_npz(te.params_from_jax(jax_init_params(jax.random.PRNGKey(0), cfg)),
                       te.init_cache_path(cfg))
    root = tmp_path_factory.mktemp("bert-slice")
    repo = root / "repo"
    (repo / "src").mkdir(parents=True)
    for f, noun in enumerate(NOUNS):
        body = "\n\n".join(
            f"def {verb}_{noun}(arg):\n    return arg.{noun}_{i}\n" for i, verb in enumerate(VERBS))
        (repo / "src" / f"{noun}.py").write_text(body)
    jax_db, port_db = root / "jax-db", root / "port-db"
    assert jax_index(repo, JaxIndexOptions(store_path=jax_db, model=MODEL)).chunks_added >= 40
    assert index(repo, IndexOptions(store_path=port_db, model=MODEL),
                 device="cpu").chunks_added >= 40
    return repo, jax_db, port_db


def _rows_by_hash(db) -> dict:
    store = JaxVectorStore(db, dims=384, readonly=True)
    rows = np.asarray(store._rows_range(0, store._rows), np.float32)
    row_of = {int(cid): r for r, cid in enumerate(store._cids.view())}
    return {m.hash: rows[row_of[cid]] for cid, m in store.iter_chunks()}


def test_both_packages_store_rows_that_agree(indexes):
    _, jax_db, port_db = indexes
    jrows, trows = _rows_by_hash(jax_db), _rows_by_hash(port_db)
    assert set(jrows) == set(trows)
    cos = [float(jrows[h] @ trows[h] / (np.linalg.norm(jrows[h]) * np.linalg.norm(trows[h])))
           for h in jrows]
    assert min(cos) >= ROW_COS_MIN


def _force_device_routes(session) -> None:
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    session.fts.plane_df_floor = 8


def _legs(session, query, mode, port: bool):
    """(vector chunk ids, vector scores) per variant and the BM25 leg
    [(chunk id, score)] of one fused hybrid call."""
    st = session._prep_query(query, SearchOptions(limit=10, mode=mode, no_expand=True))
    ids, mask = st["feats"]
    backend = session.service.backend
    if port:
        vv, vi, bv, bi = to_host(*session.store.dispatch(backend, ids, mask, st["fetch"],
                                                         st["bm"]))
    else:
        vv, vi, bv, bi = session.store.hybrid_search_encoded(
            backend.params, backend.cfg, ids, mask, st["fetch"], st["bm"], raw=True,
            defer=True)
    cids, scores = session.store.rows_to_ids(np.asarray(vv), np.asarray(vi))
    bm = session.fts.results_from_device(np.asarray(bv), np.asarray(bi), st["fetch"])
    return cids, scores, [(r.chunk_id, r.score) for r in bm]


def _assert_same_up_to_near_ties(tc, jc, jsc) -> None:
    """Every chunk the port ranks at position i scores, by the JAX query
    vector, within 2 * SCORE_TOL of JAX's i-th score (a chunk outside JAX's
    list must sit at its tail)."""
    for v in range(jc.shape[0]):
        jscore = dict(zip(jc[v].tolist(), jsc[v].tolist()))
        for i, cid in enumerate(tc[v].tolist()):
            ref = jscore.get(cid, jsc[v, -1])
            assert abs(ref - jsc[v, i]) <= 2 * SCORE_TOL, (v, i, cid)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_searches_both_indexes(indexes, writer):
    _, jax_db, port_db = indexes
    db = jax_db if writer == "jax" else port_db
    js, ts = JaxSession(db), SearchSession(db, device="cpu")
    for s in (js, ts):
        _force_device_routes(s)
    fused_topk.reset_launch_counts()
    attention.reset_launch_counts()
    for query, mode in QUERIES:
        jc, jsc, jbm = _legs(js, query, "hybrid", port=False)
        tc, tsc, tbm = _legs(ts, query, "hybrid", port=True)
        assert [c for c, _ in tbm] == [c for c, _ in jbm] and jbm, query
        np.testing.assert_allclose([s for _, s in tbm], [s for _, s in jbm], atol=BM25_TOL)
        assert tc.shape == jc.shape
        np.testing.assert_allclose(tsc, jsc, atol=SCORE_TOL)
        _assert_same_up_to_near_ties(tc, jc, jsc)
        resp = ts.search(query, SearchOptions(limit=5, mode=mode, no_expand=True))
        assert resp.hits and all(np.isfinite(h.score) for h in resp.hits)
    # on the CPU every kernel wrapper took its plain version
    assert not any(fused_topk.launch_counts.values())
    assert not any(attention.launch_counts.values())
    assert ts.store._device[1].device.type == "cpu"


def test_port_session_embeds_queries_with_the_bert_backend(indexes):
    _, _, port_db = indexes
    ts = SearchSession(port_db, device="cpu")
    assert isinstance(ts.service.backend, _BertBackend)
    st = ts._prep_query("validate the schema", SearchOptions(limit=5))
    ids, mask = st["feats"]
    assert mask.dtype == np.int32 and set(np.unique(mask)) <= {0, 1}
    assert ids.shape == mask.shape and ids.shape[1] in (16, 32, 64)
    vecs = ts.service.backend.encoder.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(vecs.norm(dim=1).numpy(), 1.0, atol=1e-5)


def test_cli_index_model_flag_and_search_json(indexes, tmp_path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from codesearch_tpu_torch.cli import main

    repo, _, _ = indexes
    db = tmp_path / "db"
    # --model after the subcommand, as after the program name
    assert main(["--platform", "cpu", "--quiet", "--store", str(db), "index", "--model", MODEL,
                 str(repo)]) == 0
    assert json.loads((db / "metadata.json").read_text())["model"] == MODEL
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "codesearch_tpu_torch.cli", "--platform", "cpu", "--store",
         str(db), "search", "validate the schema", str(repo), "--json", "--limit", "3"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(root)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    hits = json.loads(proc.stdout)["results"]
    assert len(hits) == 3 and all(h["path"].startswith("src/") for h in hits)
