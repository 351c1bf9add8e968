"""What the benchmark finds by name: the cell's entry in ``BENCHMARK.json``,
its configuration and traffic files, the configuration's encoder family,
each per-layer metric's reader and the cell's limits. A configuration, an
encoder family, a traffic mix, a per-layer metric or a cell's limits is
added as a new file and a new entry; no file here changes.

- ``configs`` entries name their file; the file holds the published
  configuration (``config``), its encoder ``family``, the registry model
  that serves it, and ``assumed`` / ``reduced``.
- ``bench_cells/families/<family>.py`` is one encoder family. It imports
  only ``torch``, ``numpy`` and ``bench_cells`` and defines
  ``dims(config_file)`` (the sizes under the names every family has,
  ``family``, ``hidden``, ``layers``, ``heads``, ``intermediate``,
  ``vocab``, ``positions``, ``eps``, ``pooling`` and ``type_vocab``, and
  any of its own), ``tensor_specs(dims)`` (the checkpoint's tensors in the
  order the seeded weights are drawn), ``matmul_params(dims)`` (the weights
  of the matrix products, all layers), ``layer_windows(dims)`` (each
  layer's attention window: 0 for full attention, w for the keys with
  |i - j| <= w // 2), ``forward(enc, ids, mask)`` (its float32 reference
  forward over ``reference.encoder.Encoder``'s pieces, pooled to [B,
  hidden]) and ``served(dims)`` (the program's ``ArchConfig`` attributes
  and the values the configuration requires of them).
- ``bench_cells/traffic/<traffic>.json`` holds the mix's parameters and the
  ``driver`` (a module of ``bench_cells/drivers``) that runs it.
- ``bench_cells/metrics/<metric name>.py`` defines ``read(trace) -> float |
  None`` for a per-layer metric; None leaves the metric out of the line.
- ``bench_cells/limits/<workload>.json`` holds the limit of each number the
  cell's correctness check compares.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

from .families import family

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "codesearch_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def model_dims(cfg: dict) -> dict:
    """The encoder's sizes from a configuration file's published ``config``,
    under one set of names for every family (its module's ``dims``)."""
    return family(cfg["family"]).dims(cfg)


class Cell:
    """One workload of the benchmark, with everything it names loaded."""

    def __init__(self, name: str, root: Path = ROOT, bench: dict | None = None):
        self.root = root
        self.bench = bench or load_benchmark(root)
        self.workload = find(self.bench["workloads"], name, "workload")
        self.name = name
        entry = find(self.bench["configs"], self.workload["config"], "configuration")
        self.config = json.loads((root / entry["file"]).read_text())
        self.dims = model_dims(self.config)
        self.traffic = json.loads(
            (root / "bench_cells" / "traffic" / f"{self.workload['traffic']}.json").read_text())
        lim = root / "bench_cells" / "limits" / f"{name}.json"
        self.limits = json.loads(lim.read_text()) if lim.exists() else {}

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self._applies(m) and m["moves"] in reported]

    def driver(self):
        return importlib.import_module(f"bench_cells.drivers.{self.traffic['driver']}")


def metric_reader(name: str, root: Path = ROOT):
    path = root / "bench_cells" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_cells_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(out)
