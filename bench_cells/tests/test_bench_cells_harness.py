"""The harness: the result line's format, the whole-name check for JAX,
``BENCHMARK.json`` against the contract, cells found by name from data
files alone, and the command's refusals."""

import hashlib
import json
import re
import shutil
import subprocess
import sys

from bench_cells.harness import HERE, ROOT, Cell, forbidden_loaded, load_benchmark, result_line

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_result_line_format():
    line = result_line(True, 400, 0, {"query_p95_ms": {"value": 21.5, "unit": "ms"}},
                       {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                        "memory_peak_bytes": 123}, [("query_vector", 1e-4, 1e-3)],
                       {"device_ops": [["k", 0.1]], "idle_gaps": [["bench.query", 0.2]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"] == {"query_vector": {"value": 1e-4, "limit": 1e-3}}
    assert "\n" not in line


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_loaded(["jax", "jax.numpy", "jaxlib.xla", "flax.linen",
                             "codesearch_tpu", "codesearch_tpu.ops.topk"]) == [
        "codesearch_tpu", "codesearch_tpu.ops.topk", "flax.linen", "jax", "jax.numpy",
        "jaxlib.xla"]
    assert forbidden_loaded(["codesearch_tpu_torch", "codesearch_tpu_torch.ops",
                             "jaxtyping", "flaxen", "torch"]) == []


def test_harness_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); import bench_cells.run as r; "
            "import bench_cells.drivers.agent_query, bench_cells.drivers.index_repos; "
            "from bench_cells.harness import forbidden_loaded; "
            "print(forbidden_loaded(sys.modules))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        src = path.read_text()
        assert "codesearch_tpu" not in src, path
        assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", src, re.M), path


def test_benchmark_json_meets_the_contract():
    b = load_benchmark(ROOT)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"][1].startswith(b["paths"][0] + "/")
    assert 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("bench_cells/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    assert len(json.dumps(b)) < 64 * 1024


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and the cell's
    limits, added as new files and new entries: the harness finds them and
    no file it had changes."""
    shutil.copytree(HERE, tmp_path / "bench_cells",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bench_cells")
    b = load_benchmark(ROOT)
    cfg = json.loads((HERE / "configs" / "bge-small.json").read_text())
    (tmp_path / "bench_cells" / "configs" / "throwaway.json").write_text(
        json.dumps({**cfg, "name": "throwaway"}))
    traffic = json.loads((HERE / "traffic" / "agent-query.json").read_text())
    traffic["queries"]["min_count"] = 77
    (tmp_path / "bench_cells" / "traffic" / "throwaway-mix.json").write_text(json.dumps(traffic))
    (tmp_path / "bench_cells" / "metrics" / "throwaway.metric.query.py").write_text(
        "def read(trace):\n    return trace.get('queries')\n")
    (tmp_path / "bench_cells" / "limits" / "throwaway.cell.json").write_text(
        json.dumps({"query_vector": 0.5}))
    b["configs"].append({"name": "throwaway", "source": "https://example.org/x",
                         "file": "bench_cells/configs/throwaway.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "throwaway.cell", "config": "throwaway",
                           "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] in ("query_p95_ms", "queries_per_s"):
            m["workloads"].append("throwaway.cell")
    b["per_layer"].append({"name": "throwaway.metric.query", "unit": "queries",
                           "better": "higher", "source": "program_counter", "layer": "read plane",
                           "moves": "query_p95_ms", "workloads": ["throwaway.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = Cell("throwaway.cell", tmp_path)
    assert cell.config["name"] == "throwaway" and cell.traffic["queries"]["min_count"] == 77
    assert cell.limits == {"query_vector": 0.5}
    assert cell.driver().__name__ == "bench_cells.drivers.agent_query"
    assert [m["name"] for m in cell.per_layer()] == ["throwaway.metric.query"]
    from bench_cells.harness import metric_reader

    assert metric_reader("throwaway.metric.query", tmp_path)({"queries": 3}) == 3
    after = _digest(tmp_path / "bench_cells")
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_command_refuses_without_a_card(tmp_path):
    """Without CUDA the command exits 2 and prints no result line."""
    out = subprocess.run([sys.executable, "bench_cells/run.py", "--workload",
                          "bge-small.agent-query", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
                                        "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""


def test_the_command_fails_with_only_its_own_files(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, the program cannot be imported: no result, a non-zero exit."""
    shutil.copytree(HERE, tmp_path / "bench_cells",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = "import bench_cells.drivers.agent_query as aq; aq.run(None)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env={"PATH": "/usr/bin:/bin",
                                                         "PYTHONPATH": str(tmp_path),
                                                         "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "codesearch_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
