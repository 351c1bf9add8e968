"""The port's CLI held to the JAX CLI, subcommand by subcommand, on the same
tiny repositories (``--platform cpu``: the kernels' plain versions).

Both packages share one on-disk format, so each JAX command reads the
index the port wrote, and its JSON must equal the port's field by field.
Every test runs in its own directory with its own ``CODESEARCH_HOME``, so
database discovery sees neither the test session's registry nor the
repository it runs from, and under a 120 s alarm. Only hash models are
used; one test runs ``train``.
"""

from __future__ import annotations

import importlib
import json
import shutil
import signal
import subprocess

import numpy as np
import pytest
import torch

from codesearch_tpu.cli.main import build_parser as jax_parser
from codesearch_tpu.cli.main import main as jax_main
from codesearch_tpu.models import hash_embedder as jh
from codesearch_tpu_torch.models import hash_embedder as th

tcli = importlib.import_module("codesearch_tpu_torch.cli.main")
tdoc = importlib.import_module("codesearch_tpu_torch.cli.doctor")

TEST_LIMIT_S = 120
DIMS = 384
VERBS = ["parse", "walk", "render", "compute", "merge", "flush", "encode", "resolve",
         "validate", "dispatch"]
NOUNS = ["config", "tree", "buffer", "index", "token", "matrix", "query", "chunk", "socket",
         "widget"]
QUERY = "parse the config and return it"


@pytest.fixture(autouse=True)
def _bounded():
    """Fail the test, instead of hanging the run, past TEST_LIMIT_S."""
    def expired(signum, frame):
        pytest.fail(f"the test ran past its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, TEST_LIMIT_S)
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both packages' cached default hash tables (the same bf16 bits), made
    once for the file: the JAX package writes its own, and the port's is
    written from it (the port's numpy generation takes ~20 s)."""
    d = tmp_path_factory.mktemp("tables")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODESEARCH_HOME", str(d))
        bits = np.asarray(jh.make_table(DIMS)).view(np.uint16).ravel()
        bits.tofile(th._table_bits_path(DIMS, th.VOCAB_BUCKETS))
    return d


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch, tables):
    h = tmp_path / "home"
    h.mkdir()
    for f in tables.iterdir():
        (h / f.name).symlink_to(f)
    monkeypatch.setenv("CODESEARCH_HOME", str(h))
    monkeypatch.chdir(tmp_path)
    return h


def make_repo(path, files: int = 3):
    path.mkdir()
    for f in range(files):
        (path / f"mod{f}.py").write_text("\n\n".join(
            f'def {v}_{o}_{f}(data, limit=10):\n    """{v.capitalize()} the {o} and return '
            f'the updated {o}."""\n    out = []\n    for item in data[:limit]:\n'
            f'        out.append(item * {i + 1})\n    return out\n'
            for i, (v, o) in enumerate(zip(VERBS, NOUNS[f:] + NOUNS[:f]))))
    return path


def port(capsys, *argv) -> tuple[int, str, str]:
    capsys.readouterr()
    rc = tcli.main(["--platform", "cpu", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def jax(capsys, *argv) -> tuple[int, str, str]:
    capsys.readouterr()
    rc = jax_main(["--platform", "cpu", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def indexed(capsys, path, *flags):
    repo = make_repo(path)
    assert port(capsys, "-q", "index", str(repo), *flags)[0] == 0
    return repo


def files_under(path) -> dict:
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

def _subparsers(parser) -> dict:
    action = next(a for a in parser._actions if a.dest == "command")
    return action.choices


def test_every_subcommand_of_the_jax_cli_is_ported():
    jax_cmds, port_cmds = _subparsers(jax_parser()), _subparsers(tcli.build_parser())
    assert set(tcli.PORTED) == set(jax_cmds) == set(port_cmds)
    for name, sub in jax_cmds.items():
        want = {a.dest for a in sub._actions}
        got = {a.dest for a in port_cmds[name]._actions}
        assert want <= got, (name, want - got)


def test_subcommands_that_open_stores_need_cuda_unless_the_cpu_is_named(
        tmp_path, capsys, monkeypatch):
    repo = indexed(capsys, tmp_path / "repo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["stats", str(repo)], ["list", str(repo)], ["doctor", str(repo)],
                 ["search", QUERY, "--all-repos"]):
        capsys.readouterr()
        assert tcli.main(argv) == 1, argv
        assert "no CUDA device" in capsys.readouterr().err, argv
    # the registry, the caches and the model list are files only
    assert tcli.main(["index", "list"]) == 0
    assert tcli.main(["cache", "stats"]) == 0
    assert tcli.main(["setup", "--list"]) == 0
    assert "not yet ported" not in capsys.readouterr().err


# ---------------------------------------------------------------------------
# stats, list, clear
# ---------------------------------------------------------------------------

def test_stats_json_equals_the_jax_cli_on_the_ports_index(tmp_path, capsys):
    repo = indexed(capsys, tmp_path / "repo")
    rc, out, _ = port(capsys, "stats", str(repo), "--json")
    got = json.loads(out)
    jrc, jout, _ = jax(capsys, "stats", str(repo), "--json")
    assert rc == jrc == 0 and got == json.loads(jout)
    assert got["vector"]["chunks"] == got["fts"]["docs"] == 30 and got["files"] == 3
    assert got["vector"]["bloat_ratio"] == 1.0 and got["fts"]["planes_enabled"] is True
    # --store names the database directly (the JAX CLI reads only the path)
    assert json.loads(port(capsys, "--store", str(repo / ".codesearch.db"), "stats",
                           str(tmp_path), "--json")[1]) == got
    text = port(capsys, "stats", str(repo))[1]
    assert "chunks: 30" in text and "serving: planes on" in text


def test_store_readers_equal_the_jax_stores(tmp_path, capsys):
    import dataclasses

    from codesearch_tpu.fts import FtsStore as JaxFts
    from codesearch_tpu.vectordb import VectorStore as JaxStore
    from codesearch_tpu_torch.fts import FtsStore
    from codesearch_tpu_torch.vectordb import VectorStore

    db = indexed(capsys, tmp_path / "repo") / ".codesearch.db"
    store, jstore = VectorStore(db, DIMS, readonly=True, device="cpu"), JaxStore(db, DIMS,
                                                                                 readonly=True)
    assert dataclasses.asdict(store.stats()) == dataclasses.asdict(jstore.stats())
    assert store.all_paths() == jstore.all_paths() == {"mod0.py", "mod1.py", "mod2.py"}
    assert store.stats().tombstones == 0 and store.stats().chunk_count == 30
    got = FtsStore(db / "fts", readonly=True, device="cpu").stats()
    assert got == JaxFts(db / "fts", readonly=True).stats() and got["docs"] == 30


def test_stats_of_an_int8_index_counts_its_int8_matrix(tmp_path, capsys):
    # the port opens an int8 index as int8 (as its servers do); the JAX
    # CLI's stats opens it as bf16 and counts two bytes an entry
    repo = indexed(capsys, tmp_path / "repo", "--int8")
    got = json.loads(port(capsys, "stats", str(repo), "--json")[1])
    want = json.loads(jax(capsys, "stats", str(repo), "--json")[1])
    assert got["vector"].pop("device_bytes") * 2 == want["vector"].pop("device_bytes")
    assert got == want


def test_list_equals_the_jax_cli(tmp_path, capsys):
    indexed(capsys, tmp_path / "a")
    indexed(capsys, tmp_path / "b")
    rc, out, _ = port(capsys, "list")
    assert rc == 0 and out == jax(capsys, "list")[1]
    assert [line.split()[0] for line in out.splitlines()] == [
        str(tmp_path / "a" / ".codesearch.db"), str(tmp_path / "b" / ".codesearch.db")]
    assert all("chunks=30" in line for line in out.splitlines())
    (tmp_path / "empty").mkdir()
    assert port(capsys, "list", str(tmp_path / "empty"))[1] == "no databases found\n"


def test_clear_refuses_without_yes_and_deletes_with_it(tmp_path, capsys):
    repo = indexed(capsys, tmp_path / "repo")
    db = repo / ".codesearch.db"
    before = files_under(db)
    rc, _, err = port(capsys, "clear", str(repo))
    assert rc == 1 and "pass --yes" in err and files_under(db) == before
    assert jax(capsys, "clear", str(repo))[:3:2] == (1, err)
    assert port(capsys, "clear", str(repo), "--yes")[0] == 0 and not db.exists()
    rc, _, err = port(capsys, "stats", str(repo))
    assert rc == 1 and "no index found" in err


# ---------------------------------------------------------------------------
# cache, setup
# ---------------------------------------------------------------------------

def test_cache_stats_and_clear_equal_the_jax_cli(tmp_path, home, capsys):
    indexed(capsys, tmp_path / "repo")
    rc, out, _ = port(capsys, "cache", "stats")
    got = json.loads(out)
    assert rc == 0 and got == json.loads(jax(capsys, "cache", "stats")[1])
    assert list(got["models"]) == ["code-hash-384-torch-v4"] and got["total_bytes"] > 0
    rc, _, err = port(capsys, "cache", "clear")
    assert rc == 1 and "pass --yes" in err and (home / "embedding_cache").exists()
    assert port(capsys, "cache", "clear", "--yes")[0] == 0
    assert not (home / "embedding_cache").exists()
    assert json.loads(port(capsys, "cache", "stats")[1]) == {"total_bytes": 0, "models": {}}


def test_embedding_service_cache_stats_matches_the_jax_service(tmp_path):
    from codesearch_tpu.embed import EmbeddingService as JaxService
    from codesearch_tpu_torch.chunker import SemanticChunker
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.fileio.language import detect_language

    repo = make_repo(tmp_path / "repo", files=1)
    chunks = SemanticChunker(60, 2000, 5).chunk_semantic(
        detect_language(repo / "mod0.py"), "mod0.py", (repo / "mod0.py").read_text())
    svc, jsvc = EmbeddingService("code-hash-384", device="cpu"), JaxService("code-hash-384")
    for s in (svc, jsvc):
        s.embed_chunks_matrix(chunks)
        s.embed_chunks_matrix(chunks[:4])
        s.embed_query(QUERY)
        s.embed_query(QUERY)
    got, want = svc.cache_stats(), jsvc.cache_stats()
    assert got.keys() == want.keys() == {"memory", "query", "persistent"}
    assert got["query"] == want["query"] == {"entries": 1, "hits": 1, "misses": 1}
    assert got["memory"] == want["memory"] and got["memory"]["hits"] == 4
    assert got["persistent"]["entries"] == want["persistent"]["entries"] == len(chunks)
    assert svc.persistent.dir.name == "code-hash-384-torch-v4"


def test_setup_lists_and_imports_as_the_jax_cli(tmp_path, home, capsys):
    rc, out, _ = port(capsys, "setup", "--list")
    assert rc == 0 and out == jax(capsys, "setup", "--list")[1]
    assert "code-hash-384" in out and "bge-small" in out
    src = tmp_path / "assets"
    src.mkdir()
    (src / "config.json").write_text('{"hidden_size": 64}')
    (src / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    assert port(capsys, "setup", "--import", str(src))[:3:2] == (
        1, "error: --import requires --as <short-name> (see setup --list)\n")
    assert port(capsys, "setup", "--import", str(src), "--as", "no-such-model")[0] == 1
    (tmp_path / "none").mkdir()
    assert port(capsys, "setup", "--import", str(tmp_path / "none"), "--as", "bge-small")[0] == 1
    assert not (home / "models" / "bge-small").exists()
    assert port(capsys, "setup", "--import", str(src), "--as", "bge-small")[0] == 0
    got = files_under(home / "models" / "bge-small")
    shutil.rmtree(home / "models" / "bge-small")
    assert jax(capsys, "setup", "--import", str(src), "--as", "bge-small")[0] == 0
    assert got == files_under(home / "models" / "bge-small") == files_under(src)


# ---------------------------------------------------------------------------
# doctor
# ---------------------------------------------------------------------------

def test_doctor_json_equals_the_jax_cli(tmp_path, capsys):
    repo = indexed(capsys, tmp_path / "repo")
    rc, out, _ = port(capsys, "doctor", str(repo), "--json")
    got = json.loads(out)
    jrc, jout, _ = jax(capsys, "doctor", str(repo), "--json")
    assert rc == jrc == 0 and got == json.loads(jout)
    assert [c["name"] for c in got] == [
        "database", "structure", "model", "placement", "file_integrity", "chunk_integrity",
        "bloat", "fts", "serving_state", "embedding_cache"]
    assert all(c["ok"] for c in got)
    assert "device_roundtrip" not in out      # only `--device` pays the probe
    text = port(capsys, "doctor", str(repo))[1]
    assert text.count("✓") == len(got) and "✗" not in text


def test_doctor_fix_repairs_a_store_out_of_step_with_the_disk(tmp_path, capsys):
    repo = indexed(capsys, tmp_path / "repo")
    (repo / "mod2.py").unlink()
    (repo / "extra.py").write_text("def fresh_function(x):\n    return x + 1\n")
    rc, out, _ = port(capsys, "doctor", str(repo), "--json")
    got = json.loads(out)
    assert rc == 1 and got == json.loads(jax(capsys, "doctor", str(repo), "--json")[1])
    bad = {c["name"]: c["detail"] for c in got if not c["ok"]}
    assert list(bad) == ["file_integrity"]
    assert "1 unindexed, 1 stale" in bad["file_integrity"]
    rc, out, _ = port(capsys, "doctor", str(repo), "--fix", "--json")
    assert rc == 0 and all(c["ok"] for c in json.loads(out))
    assert jax(capsys, "doctor", str(repo), "--json")[0] == 0
    assert json.loads(port(capsys, "stats", str(repo), "--json")[1])["vector"]["chunks"] == 21


def test_doctor_without_a_database_fails_as_the_jax_cli(tmp_path, capsys):
    rc, out, _ = port(capsys, "doctor", str(tmp_path), "--json")
    assert rc == 1 and out == jax(capsys, "doctor", str(tmp_path), "--json")[1]
    assert [c["name"] for c in json.loads(out)] == ["database"]


def test_doctor_device_probe_runs_torch_on_the_named_device(tmp_path, capsys, monkeypatch):
    repo = indexed(capsys, tmp_path / "repo")
    monkeypatch.setattr(tdoc, "PROBE_TIMEOUT_S", 60.0)
    rc, out, _ = port(capsys, "doctor", str(repo), "--json", "--device")
    probe = json.loads(out)[-1]
    assert rc == 0 and probe["name"] == "device_roundtrip" and probe["ok"], probe
    assert probe["detail"].startswith("device=cpu, round trip ")
    assert "import jax" not in tdoc._PROBE and "codesearch" not in tdoc._PROBE


def test_doctor_probe_is_bounded_and_reports_a_timeout(monkeypatch):
    calls = []

    def hang(*args, **kwargs):
        calls.append(kwargs)
        raise subprocess.TimeoutExpired("probe", kwargs.get("timeout", 0))

    monkeypatch.setattr(subprocess, "run", hang)
    res = tdoc.check_device_roundtrip(timeout_s=1.0)
    assert res.name == "device_roundtrip" and not res.ok
    assert "no round trip within 1s" in res.detail and "readback" in res.detail
    assert calls[0]["timeout"] == 1.0 and calls[0]["stdin"] is subprocess.DEVNULL
    assert calls[0]["check"] is True


def test_doctor_probe_failure_is_a_failed_check(monkeypatch):
    def crash(*args, **kwargs):
        raise subprocess.CalledProcessError(1, args[0], stderr="RuntimeError: no device")

    monkeypatch.setattr(subprocess, "run", crash)
    res = tdoc.check_device_roundtrip(platform="cuda")
    assert not res.ok and "exit 1" in res.detail and "no device" in res.detail


# ---------------------------------------------------------------------------
# index: the registry and --dry-run
# ---------------------------------------------------------------------------

def test_index_registry_actions_share_the_jax_registry(tmp_path, capsys):
    a, b = make_repo(tmp_path / "a"), make_repo(tmp_path / "b")
    assert port(capsys, "index", "add", str(a))[0] == 0
    assert jax(capsys, "index", "add", str(b))[0] == 0
    rc, out, _ = port(capsys, "index", "list")
    assert rc == 0 and out == jax(capsys, "index", "list")[1] == f"{a}\n{b}\n"
    assert port(capsys, "index", "rm", str(a))[0] == 0
    assert jax(capsys, "index", "list")[1] == f"{b}\n"
    assert port(capsys, "index", "remove", str(b))[0] == 0
    assert port(capsys, "index", "list")[1] == ""
    assert not (a / ".codesearch.db").exists() and not (b / ".codesearch.db").exists()


def test_index_dry_run_writes_nothing_and_reports_as_the_jax_cli(tmp_path, home, capsys):
    repo = make_repo(tmp_path / "repo")
    home_before = files_under(home)
    rc, _, err = port(capsys, "index", str(repo), "--dry-run")
    assert rc == 0 and err == jax(capsys, "index", str(repo), "--dry-run")[2]
    assert "dry run: 3 to index, 0 unchanged, 0 deleted" in err
    assert not (repo / ".codesearch.db").exists() and files_under(home) == home_before
    assert port(capsys, "-q", "index", str(repo))[0] == 0
    (repo / "mod0.py").write_text("def changed():\n    return 0\n")
    (repo / "mod1.py").unlink()
    db_before = files_under(repo / ".codesearch.db")
    rc, _, err = port(capsys, "index", str(repo), "--dry-run")
    assert rc == 0 and err == jax(capsys, "index", str(repo), "--dry-run")[2]
    assert f"would index: {repo / 'mod0.py'}" in err and "would remove:" in err
    assert "dry run: 1 to index, 1 unchanged, 1 deleted" in err
    assert files_under(repo / ".codesearch.db") == db_before


# ---------------------------------------------------------------------------
# search --all-repos
# ---------------------------------------------------------------------------

def _unopenable(path):
    """A registered repository whose index discovery accepts but a session
    refuses: built with an older embedder version."""
    repo = make_repo(path, files=1)
    db = repo / ".codesearch.db"
    (db / "fts").mkdir(parents=True)
    (db / "vectors.json").write_text("{}")
    (db / "metadata.json").write_text(json.dumps(
        {"model": "code-hash-384", "dimensions": DIMS, "embedder_version": 1}))
    return repo


def test_search_all_repos_equals_the_jax_cli_and_each_repos_own_search(tmp_path, capsys):
    a = indexed(capsys, tmp_path / "a")
    b = indexed(capsys, tmp_path / "b", "--int8")
    bad = _unopenable(tmp_path / "bad")
    for repo in (a, b, bad):
        assert port(capsys, "index", "add", str(repo))[0] == 0
    cwd = tmp_path / "elsewhere"
    cwd.mkdir()
    args = ("search", QUERY, str(cwd), "--all-repos", "--limit", "5")
    rc, out, _ = port(capsys, *args, "--json")
    groups = json.loads(out)
    assert rc == 0 and groups == json.loads(jax(capsys, *args, "--json")[1])
    assert [g["db_path"] for g in groups] == [str(r / ".codesearch.db") for r in (a, b, bad)]
    assert "embedder v1" in groups[2]["error"] and "results" not in groups[2]
    for repo, group in zip((a, b), groups):
        own = json.loads(port(capsys, "search", QUERY, str(repo), "--limit", "5", "--json")[1])
        assert group == {"db_path": str(repo / ".codesearch.db"), **own}
        assert len(own["results"]) == 5 and own["results"][0]["path"] == "mod0.py"
    # grouped text: one section per answering database, the bad one skipped
    rc, out, err = port(capsys, *args, "--compact")
    assert rc == 0 and (out, err) == jax(capsys, *args, "--compact")[1:]
    assert out.count("=== ") == 2 and f"[{bad / '.codesearch.db'}] skipped" in err


def test_search_all_repos_without_any_index_fails(tmp_path, capsys):
    rc, _, err = port(capsys, "search", QUERY, str(tmp_path), "--all-repos")
    assert rc == 1 and "no indexes found" in err


# ---------------------------------------------------------------------------
# train: no stale rows after the re-index
# ---------------------------------------------------------------------------

def _vectors(db) -> dict:
    """(path, start, end) -> the stored f16 row of every live chunk."""
    from codesearch_tpu_torch.vectordb import VectorStore

    store = VectorStore(db, dims=DIMS, readonly=True, device="cpu")
    rows = store._rows_range(0, store._rows)
    live = np.nonzero(store._valid.view())[0]
    out = {}
    for r in live:
        m = store.get_chunk(int(store._cids.view()[r]))
        out[(m.path, m.start_line, m.end_line)] = rows[r]
    return out


def test_train_reindexes_without_stale_rows(tmp_path, capsys):
    repo = indexed(capsys, tmp_path / "repo")
    db = repo / ".codesearch.db"
    _, _, err = port(capsys, "index", str(make_repo(tmp_path / "tipped")))
    assert "tip: `codesearch-torch train`" in err
    before = json.loads(port(capsys, "stats", str(repo), "--json")[1])
    assert port(capsys, "-q", "train", str(repo), "--epochs", "2")[0] == 0
    after = json.loads(port(capsys, "stats", str(repo), "--json")[1])
    assert after["vector"]["chunks"] == before["vector"]["chunks"] == 30
    assert after["fts"]["docs"] == 30 and after["files"] == 3
    hits = json.loads(port(capsys, "search", QUERY, str(repo), "--limit", "10",
                           "--json")[1])["results"]
    keys = [(h["path"], h["start_line"]) for h in hits]
    assert len(hits) == 10 and len(set(keys)) == 10
    assert port(capsys, "doctor", str(repo))[0] == 0
    # every stored vector is the trained table's embedding of its chunk: the
    # rows of a fresh index made with the trained table
    ref = tmp_path / "ref-db"
    ref.mkdir()
    (ref / "hash_table.npz").symlink_to(db / "hash_table.npz")
    assert port(capsys, "-q", "--store", str(ref), "index", str(repo))[0] == 0
    got, want = _vectors(db), _vectors(ref)
    assert got.keys() == want.keys() and len(got) == 30
    assert all(np.array_equal(got[k], want[k]) for k in got)
    untrained = _vectors(tmp_path / "tipped" / ".codesearch.db")
    assert not all(np.array_equal(untrained[k], want[k]) for k in want)
    # a re-index with the trained table in place gives no tip
    (repo / "mod0.py").write_text((repo / "mod0.py").read_text() + "\n# edited\n")
    _, _, err = port(capsys, "index", str(repo))
    assert "indexed 1 files (10 chunks)" in err and "tip:" not in err
    (db / "hash_table.npz").unlink()     # 100 MB: keep the basetemp small


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_search_all_repos_launches_the_kernels_on_the_card(cuda, tmp_path, capsys,
                                                           monkeypatch):
    from codesearch_tpu_torch.fts import store as fts_store
    from codesearch_tpu_torch.ops import fused_topk as ft
    from codesearch_tpu_torch.vectordb import store as vec_store

    # the tiny corpora would take the host paths: send them to the device
    monkeypatch.setattr(vec_store, "HOST_PATH_ROWS", 0)
    monkeypatch.setattr(fts_store, "DEVICE_MIN_DOCS", 1)
    monkeypatch.setattr(fts_store, "PLANE_DF_FLOOR", 4)
    a = indexed(capsys, tmp_path / "a")
    b = indexed(capsys, tmp_path / "b", "--int8")
    for repo in (a, b):
        assert port(capsys, "index", "add", str(repo))[0] == 0
    (tmp_path / "elsewhere").mkdir()
    args = ["search", QUERY, str(tmp_path / "elsewhere"), "--all-repos", "--json"]
    want = json.loads(port(capsys, *args)[1])
    ft.reset_launch_counts()
    capsys.readouterr()
    assert tcli.main(args) == 0
    got = json.loads(capsys.readouterr().out)
    assert ft.launch_counts["fused_cosine_topk"] >= 1
    assert ft.launch_counts["fused_cosine_topk_int8"] >= 1
    assert ft.launch_counts["fused_scores_topk"] >= 1
    for g, w in zip(got, want):
        assert [(h["path"], h["start_line"]) for h in g["results"]] == [
            (h["path"], h["start_line"]) for h in w["results"]]
