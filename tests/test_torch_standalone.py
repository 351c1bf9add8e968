"""The port stands alone: it imports neither ``jax`` nor the JAX package.

- An AST scan of every file under ``codesearch_tpu_torch/`` and of
  ``chip_smoke.py``: no import of ``codesearch_tpu``, ``jax`` or ``jaxlib`` at
  any level (lazy imports inside functions included), and no
  ``find_spec``/``import_module``/``__import__`` of them by name.
- A subprocess with ``codesearch_tpu_torch/`` copied alone into a temporary
  directory and a meta-path finder that refuses ``codesearch_tpu`` and
  ``jax``: the CPU index -> search of code-hash-384 and of a tiny BERT, and
  the CLI's ``--json`` search, with neither module loaded at the end.
"""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "codesearch_tpu_torch"
BANNED = {"codesearch_tpu", "jax", "jaxlib"}
LOADERS = {"find_spec", "import_module", "__import__"}
FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")
               if "__pycache__" not in p.parts) + ["chip_smoke.py"]


def _banned_imports(path: Path) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0] if node.args else None
            names = [arg.value] if (fname in LOADERS and isinstance(arg, ast.Constant)
                                    and isinstance(arg.value, str)) else []
        else:
            continue
        found += [f"line {node.lineno}: {n}" for n in names if n.split(".")[0] in BANNED]
    return found


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_side_import(rel):
    assert _banned_imports(ROOT / rel) == []


def test_scan_sees_lazy_and_dynamic_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(textwrap.dedent("""
        import os
        def f():
            from codesearch_tpu.utils import constants
            import jax.numpy as jnp
        importlib.util.find_spec("codesearch_tpu")
        from . import sibling
    """))
    assert [s.split(": ")[1] for s in _banned_imports(p)] == [
        "codesearch_tpu.utils", "jax.numpy", "codesearch_tpu"]


_ALONE_SCRIPT = textwrap.dedent("""
    import contextlib, importlib.abc, io, json, pkgutil, sys
    from pathlib import Path

    class _Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "codesearch_tpu"):
                raise ImportError(name + " is refused")
            return None

    sys.meta_path.insert(0, _Refuse())
    import codesearch_tpu_torch
    assert Path(codesearch_tpu_torch.__file__).parent.parent == Path.cwd(), \\
        codesearch_tpu_torch.__file__
    for m in pkgutil.walk_packages(codesearch_tpu_torch.__path__, "codesearch_tpu_torch."):
        if not m.name.endswith("__main__"):
            __import__(m.name)
    from codesearch_tpu_torch.cli import main
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.index import IndexOptions, index
    from codesearch_tpu_torch.models.registry import MODELS, ArchConfig, ModelSpec
    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    repo, db = sys.argv[1], Path(sys.argv[2])
    stats = index(repo, IndexOptions(store_path=db / "hash", quiet=True), device="cpu")
    session = SearchSession(db / "hash", device="cpu")
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    resp = session.search("parse the configuration file", SearchOptions(limit=5))
    assert resp.hits and resp.hits[0].path.endswith("main.py"), resp.hits

    tiny = ModelSpec("tiny-bert", "test/tiny-bert", 64, "bert", arch=ArchConfig(
        vocab_size=2048, hidden=64, layers=2, heads=2, intermediate=128, max_len=64))
    svc = EmbeddingService(tiny, use_persistent_cache=False, device="cpu")
    assert svc.fused_kind() == "bert"
    assert svc.backend.embed(["def parse(path): return path"]).shape == (1, 64)
    MODELS[tiny.short_name] = tiny
    bstats = index(repo, IndexOptions(store_path=db / "bert", quiet=True, model=tiny.short_name),
                   device="cpu")
    bert_session = SearchSession(db / "bert", device="cpu")
    assert bert_session.service.fused_kind() == "bert"
    bert_session.store.host_path_rows = 0
    bert_session.fts.device_min_docs = 1
    bresp = bert_session.search("parse the configuration file", SearchOptions(limit=5))
    assert bstats.chunks_added == stats.chunks_added and bresp.hits, bresp

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--platform", "cpu", "--quiet", "--store", str(db / "hash"), "search",
                   "parse the configuration file", repo, "--json", "--limit", "3"])
    assert rc == 0, rc
    hits = json.loads(buf.getvalue())["results"]
    assert hits and hits[0]["path"].endswith("main.py"), hits
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "codesearch_tpu")]
    assert not loaded, loaded
    print("OK", stats.chunks_added, len(resp.hits), len(bresp.hits), len(hits))
""")


def test_port_runs_from_a_copy_without_the_jax_package(tmp_repo, tmp_path_factory):
    # the copy and the databases sit outside the indexed repository
    work = tmp_path_factory.mktemp("alone")
    alone = work / "alone"
    shutil.copytree(PORT, alone / "codesearch_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # only the copy is on the path: not the checkout, not an installed package
    env = dict(os.environ, PYTHONPATH=str(alone), PYTHONNOUSERSITE="1")
    proc = subprocess.run(
        [sys.executable, "-c", _ALONE_SCRIPT, str(tmp_repo), str(work / "db")],
        capture_output=True, text=True, timeout=600, env=env, cwd=alone)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")
