"""Runs one cell of the benchmark once and prints its result line.

    python bench_cells/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is found by name in
``BENCHMARK.json``; its traffic file names the driver that runs it. The run
needs as many CUDA devices as the cell asks for and exits with 2, printing
no result, without them. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers
that decide ``correct`` are also the last lines of standard error, each
beside its limit, after the set-up steps' seconds and the host's state on
either side of the window.

``--control 1`` runs the cell with its control (the reference a precision
lower) judged in the program's place, by the same comparison on the same
sample; it has to read ``correct`` false. The benchmark's measured runs
never pass it.

Each run gets a ``CODESEARCH_HOME`` of its own under ``TMPDIR`` (weights,
embedding cache, logs), removed at the end. The program's build caches stay
at fixed paths inside the checkout: the CUDA kernels under
``build/torch_kernels`` (the program's own choice), the native host library,
Triton's and torch's extension caches under ``build/bench_cells``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def prepare_environment(root: Path) -> Path:
    """This run's ``CODESEARCH_HOME`` (a new directory under ``TMPDIR``)
    with the native library's build directory linked to a fixed one in the
    checkout; the compiler caches pointed into the checkout. Set before the
    program is imported."""
    cache = root / "build" / "bench_cells"
    (cache / "native").mkdir(parents=True, exist_ok=True)
    home = Path(tempfile.mkdtemp(prefix="bench_cells_home_"))
    os.symlink(cache / "native", home / "native", target_is_directory=True)
    os.environ["CODESEARCH_HOME"] = str(home)
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    return home


def run_cell(cell, seed: int, seconds: float, trace: bool, device, home: Path,
             t_start: float, chips: int = 1, control: bool = False):
    """Runs the cell's driver and the per-layer readers; returns
    (result line, stderr lines, the driver's outcome). The process's look
    for a chip is the caller's. With ``control`` the cell's control (the
    reference a precision lower) is judged in the program's place."""
    import torch

    from bench_cells.drivers.common import Context, power_limit
    from bench_cells.harness import forbidden_loaded, metric_reader, result_line

    work = Path(tempfile.mkdtemp(prefix="bench_cells_work_"))
    try:
        ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                      device=torch.device(device), home=home, work=work, t_start=t_start,
                      control=control)
        out = cell.driver().run(ctx)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = forbidden_loaded(sys.modules)
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package were loaded: {found}")
    metrics, breakdown = {}, None
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    if trace:
        out.trace["power"] = power_limit()
        for m in cell.per_layer():
            v = metric_reader(m["name"], cell.root)(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        breakdown = {"device_ops": [[n, s] for n, s in out.trace["device_ops"]],
                     "idle_gaps": [[n, s] for n, s in out.trace["idle_gaps"]]}
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": out.memory_peak_bytes,
            "power": power_limit()}
    if trace:
        info["busy_s"] = out.trace["busy_s"]
        info["window_s"] = out.trace["window_s"]
    correct = bool(out.checks) and all(
        lim is not None and value <= lim for _name, value, lim in out.checks) \
        and out.failed == 0
    line = result_line(correct, out.attempted, out.failed, metrics, info, out.checks, breakdown)
    checks = [f"set-up {name}: {s:.3f} s" for name, s in ctx.phases.items()]
    checks += [f"host at window {when}: " + json.dumps(state)
               for when, state in ctx.host.items()]
    checks += [f"check {name}: {value!r} (limit {lim!r})" for name, value, lim in out.checks]
    checks.append(f"check failed: {out.failed} of {out.attempted} (limit 0)")
    return line, checks, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: judge the cell's control in the program's place (never a "
                         "measured run; it has to come out not correct)")
    args = ap.parse_args(argv)

    from bench_cells.harness import Cell

    cell = Cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    if chips == 1:
        os.environ["CODESEARCH_SINGLE_DEVICE"] = "1"
    home = prepare_environment(ROOT)
    try:
        line, checks, _out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                      home, T_START, chips, bool(args.control))
    finally:
        shutil.rmtree(home, ignore_errors=True)
    print(line, flush=True)
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
