"""The port's index manager and watchers, held to the JAX package's on the CPU.

Two copies of one temporary git repository, each with its own index: the
JAX package's ``IndexManager`` keeps one fresh, the port's the other. Both
see the same edits: a file changed and one deleted (a watcher batch), a
branch switch (the git HEAD watcher, then the branch refresh and its orphan
sweep) and an orphan chunk swept. After each step both indexes hold the same
chunks (ids, paths, lines, content hashes), the same file manifest and give
the same search answers (ids equal, scores within 1e-5).
"""

import shutil
import subprocess

import numpy as np
import pytest

from codesearch_tpu.embed import EmbeddingService as JaxService
from codesearch_tpu.index import IndexOptions as JaxIndexOptions
from codesearch_tpu.index import index as jax_index
from codesearch_tpu.index.file_meta import FileMetaStore
from codesearch_tpu.index.manager import IndexManager as JaxManager
from codesearch_tpu.index.manager import SharedStores as JaxStores
from codesearch_tpu.search.pipeline import SearchOptions as JaxOptions
from codesearch_tpu.search.pipeline import SearchSession as JaxSession
from codesearch_tpu.vectordb import ChunkMetadata as JaxMeta
from codesearch_tpu.watch import EventKind as JaxEventKind
from codesearch_tpu.watch import FileEvent as JaxFileEvent
from codesearch_tpu.watch import GitHeadWatcher as JaxHeadWatcher
from codesearch_tpu_torch.embed import EmbeddingService
from codesearch_tpu_torch.index import IndexOptions, index
from codesearch_tpu_torch.index.manager import IndexManager, SharedStores, WriterLock
from codesearch_tpu_torch.search import SearchOptions, SearchSession
from codesearch_tpu_torch.vectordb import ChunkMetadata
from codesearch_tpu_torch.watch import EventKind, FileEvent, GitHeadWatcher
from test_torch_slice import SCORE_TOL, _add_synthetic

QUERIES = ["parse the configuration file", "shared_registry sync", "render the widget",
           "compute a content hash"]


def _git(repo, *args) -> None:
    subprocess.run(["git", "-C", str(repo), *args], check=True, capture_output=True,
                   env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
                        "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
                        "HOME": str(repo), "PATH": "/usr/bin:/bin"})


@pytest.fixture()
def repos(tmp_path, monkeypatch):
    """(JAX side, port side): (repo, manager, head watcher, stores lock) each.
    The embedding caches start empty: both packages key them on chunk content
    alone, so vectors cached by another test's index of the same functions
    under other paths would stand in for these."""
    from test_torch_slice import jax_make_table, th

    table = th._table_bits_path(384, th.VOCAB_BUCKETS)
    if not table.exists():
        np.asarray(jax_make_table(384)).view(np.uint16).ravel().tofile(table)
    monkeypatch.setenv("CODESEARCH_HOME", str(tmp_path / "home"))
    shutil.copyfile(table, th._table_bits_path(384, th.VOCAB_BUCKETS))
    base = tmp_path / "jax"
    (base / "src").mkdir(parents=True)
    (base / ".gitignore").write_text(".codesearch.db/\n")
    (base / "src" / "main.py").write_text(
        'def parse_config(path):\n    """Parse the configuration file."""\n'
        "    with open(path) as f:\n        return f.read()\n")
    (base / "src" / "lib.rs").write_text(
        "/// Compute a content hash.\npub fn content_hash(data: &[u8]) -> u64 {\n"
        "    data.iter().fold(0u64, |h, b| h.wrapping_mul(31) + *b as u64)\n}\n")
    _add_synthetic(base, n_files=3, per_file=40)
    _git(base, "init", "-q", "-b", "main")
    _git(base, "add", "-A")
    _git(base, "commit", "-q", "-m", "base")
    port_repo = tmp_path / "port"
    shutil.copytree(base, port_repo)
    jax_index(base, JaxIndexOptions(quiet=True))
    index(port_repo, IndexOptions(quiet=True), device="cpu")
    sides = []
    for repo, stores_cls, svc, mgr_cls, watcher in (
            (base, JaxStores, JaxService("code-hash-384"), JaxManager, JaxHeadWatcher),
            (port_repo, SharedStores, EmbeddingService("code-hash-384", device="cpu"),
             IndexManager, GitHeadWatcher)):
        db = repo / ".codesearch.db"
        kw = {} if stores_cls is JaxStores else {"device": "cpu"}
        stores, lock = stores_cls.new_or_readonly(db, 384, **kw)
        assert lock is not None and not stores.readonly
        sides.append((repo, mgr_cls(repo, db, stores, svc), watcher(repo), lock))
    yield sides
    for _repo, _mgr, _watcher, lock in sides:
        lock.release()


def _chunks(mgr) -> list[tuple]:
    with mgr.stores.lock:
        return sorted((cid, m.path, m.start_line, m.end_line, m.hash, m.kind)
                      for cid, m in mgr.stores.store.iter_chunks())


def _manifest(mgr) -> dict:
    fm = FileMetaStore.load_or_create(mgr.db_path, "code-hash-384")
    root = str(mgr.project_root)
    return {p.replace(root, ""): sorted(e.chunk_ids) for p, e in fm.files.items()}


def _answers(mgr, port: bool) -> list[tuple]:
    session = (SearchSession(mgr.db_path, device="cpu") if port
               else JaxSession(mgr.db_path))
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    opts = SearchOptions if port else JaxOptions
    out = []
    for q in QUERIES:
        hits = session.search(q, opts(limit=8)).hits
        out.append(([h.chunk_id for h in hits], np.array([h.score for h in hits])))
    return out


def _assert_same_state(sides) -> None:
    (_, jmgr, _, _), (_, tmgr, _, _) = sides
    assert _chunks(tmgr) == _chunks(jmgr) and _chunks(tmgr)
    assert _manifest(tmgr) == _manifest(jmgr)
    for (tids, tscores), (jids, jscores) in zip(_answers(tmgr, True), _answers(jmgr, False)):
        assert tids == jids and tids
        np.testing.assert_allclose(tscores, jscores, rtol=0, atol=SCORE_TOL)


def _both(sides, fn) -> list:
    return [fn(repo, mgr, watcher, jax_side) for jax_side, (repo, mgr, watcher, _)
            in zip((True, False), sides)]


def test_refresh_after_an_edit_and_a_delete(repos):
    _assert_same_state(repos)

    def edit(repo, mgr, _watcher, jax_side):
        (repo / "src" / "main.py").write_text(
            'def parse_config(path):\n    """Parse the configuration file."""\n'
            "    return path.read_text()\n\n\ndef render_widget(canvas):\n"
            '    """Render the widget."""\n    canvas.blit()\n')
        (repo / "src" / "lib.rs").unlink()
        ev, kind = (JaxFileEvent, JaxEventKind) if jax_side else (FileEvent, EventKind)
        mgr.process_batch([ev(kind.MODIFIED, repo / "src" / "main.py"),
                           ev(kind.DELETED, repo / "src" / "lib.rs")])

    _both(repos, edit)
    _assert_same_state(repos)
    assert not any(c[1].endswith("lib.rs") for c in _chunks(repos[1][1]))
    # a new file and an edit, through the in-process incremental refresh
    for repo, mgr, _w, _l in repos:
        (repo / "src" / "extra.py").write_text("def extra_feature():\n    return 7\n")
        mgr.perform_incremental_refresh()
    _assert_same_state(repos)


def test_refresh_after_a_branch_switch(repos):
    for repo, _mgr, watcher, _l in repos:
        assert watcher.check() is None      # the first read only records HEAD
        _git(repo, "checkout", "-q", "-b", "feature")
        (repo / "src" / "gen_0.py").unlink()
        (repo / "src" / "widget.py").write_text(
            'def render_widget(canvas):\n    """Render the widget."""\n    canvas.blit()\n')
        _git(repo, "add", "-A")
        _git(repo, "commit", "-q", "-m", "feature")

    def switch_to(branch):
        def switch(repo, mgr, watcher, _jax_side):
            change = watcher.check()
            assert change is not None and branch in change.new_head
            mgr.refresh_for_branch_change()
            assert mgr.status == "ready"
        return switch

    _both(repos, switch_to("feature"))
    _assert_same_state(repos)
    assert not any("gen_0" in c[1] for c in _chunks(repos[1][1]))
    for repo, *_ in repos:
        _git(repo, "checkout", "-q", "main")
    _both(repos, switch_to("main"))
    _assert_same_state(repos)
    assert any("gen_0" in c[1] for c in _chunks(repos[1][1]))
    assert not any("widget.py" in c[1] for c in _chunks(repos[1][1]))


def test_sweep_orphans(repos):
    def orphan(repo, mgr, _watcher, jax_side):
        meta = (JaxMeta if jax_side else ChunkMetadata)(
            path="ghost.rs", content="x", start_line=0, end_line=1, kind="Function")
        with mgr.stores.lock:
            mgr.stores.store.insert_chunks_with_ids(np.ones((1, 384), np.float32), [meta],
                                                    ids=[99999])
            assert 99999 in mgr.stores.store.all_ids()
        return mgr.sweep_orphans()

    assert _both(repos, orphan) == [1, 1]
    _assert_same_state(repos)
    for _repo, mgr, _w, _l in repos:
        assert mgr.stores.store.get_chunk(99999) is None
        assert mgr.sweep_orphans() == 0


def test_second_writer_opens_read_only(repos):
    repo, mgr, _watcher, _lock = repos[1]
    stores, lock = SharedStores.new_or_readonly(mgr.db_path, 384, device="cpu")
    assert lock is None and stores.readonly and len(stores.store) == len(mgr.stores.store)
    stores.store.host_path_rows = 0
    assert WriterLock(mgr.db_path).acquire() is False
    # a read-only manager starts no background loop
    IndexManager(repo, mgr.db_path, stores, mgr.service).start_background()
    assert stores.store.device.type == "cpu" and stores.fts.device.type == "cpu"
