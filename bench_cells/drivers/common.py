"""Pieces both drivers use: the run's context, the program's service built
and held to the configuration, the check numbers, and the device's state."""

from __future__ import annotations

import contextlib
import gc
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..families import family
from ..gen.weights import make_weights, write_checkpoint
from ..trace import Tracer


@dataclass
class Context:
    cell: object                 # harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    home: Path                   # this run's CODESEARCH_HOME
    work: Path                   # this run's scratch directory
    t_start: float               # process start, host clock
    control: bool = False        # the reference a precision lower in the program's place
    tracer: Tracer = field(init=False)
    phases: dict = field(default_factory=dict)   # set-up seconds by step
    host: dict = field(default_factory=dict)     # the host's state around the window

    def __post_init__(self):
        self.tracer = Tracer(self.trace)

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t


@dataclass
class Outcome:
    """What a driver hands back to the harness."""

    e2e: dict                    # end-to-end metric -> value
    attempted: int
    failed: int
    checks: list                 # (name, value, limit)
    trace: dict                  # what the per-layer readers read
    memory_peak_bytes: int


def host_probe_ms() -> float:
    """Milliseconds a fixed piece of pure-Python work takes: the host's
    speed for the single-threaded work that paces the cells."""
    t = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc ^= i * 2654435761 & 0xFFFF
    return (time.perf_counter() - t) * 1e3


def host_state() -> dict:
    """The host's speed and load at one moment: the probe, the load
    average, the bytes the page cache still has to write, this process's
    resident memory and the collector's full collections so far."""
    state = {"probe_ms": host_probe_ms(), "gc_full": gc.get_stats()[2]["collections"]}
    try:
        state["loadavg"] = float(Path("/proc/loadavg").read_text().split()[0])
        mem = dict(ln.split(":", 1) for ln in Path("/proc/meminfo").read_text().splitlines())
        state["dirty_mb"] = (int(mem["Dirty"].split()[0])
                             + int(mem["Writeback"].split()[0])) / 1024
        for ln in Path("/proc/self/status").read_text().splitlines():
            if ln.startswith("VmRSS:"):
                state["rss_mb"] = int(ln.split()[1]) / 1024
    except (OSError, KeyError, ValueError):
        pass
    return state


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def install_weights(ctx: Context) -> None:
    """Seeded weights written where the program's service looks for them."""
    cfg = ctx.cell.config
    w = make_weights(ctx.cell.dims, ctx.seed, ctx.device)
    write_checkpoint(w, ctx.home / "models" / cfg["registry_model"] / "model.safetensors")
    del w


def reference_weights(ctx: Context) -> dict:
    """The same weights again, for the reference (made from the seed, not
    read from the program)."""
    return make_weights(ctx.cell.dims, ctx.seed, ctx.device)


def check_served_model(spec, home: Path, cfg: dict, dims: dict) -> None:
    """The program's registry entry serves the model the configuration
    states, with the hashing tokenizer (no vocabulary beside the weights),
    or the run is not sound. Its ``ArchConfig`` is held to the sizes every
    family has and to the attributes the family module's ``served`` names."""
    want = {"hidden": dims["hidden"], "layers": dims["layers"], "heads": dims["heads"],
            "intermediate": dims["intermediate"], "vocab_size": dims["vocab"],
            "layer_norm_eps": dims["eps"], "pooling": dims["pooling"],
            **family(dims["family"]).served(dims)}
    got = {name: getattr(spec.arch, name) for name in want}
    want["query_prefix"], got["query_prefix"] = cfg["query_prefix"], spec.query_prefix
    if want != got:
        raise RuntimeError(f"the program serves {got}, the configuration states {want}")
    model_dir = home / "models" / spec.short_name
    vocab = [n for n in ("tokenizer.json", "vocab.txt") if (model_dir / n).exists()]
    if vocab:
        raise RuntimeError(f"{vocab} beside the weights: the configuration assumes the "
                           "hashing tokenizer")


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, stdin=subprocess.DEVNULL)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Window:
    """The measured window: ``open()`` starts the clock, ``due()`` says
    whether another call may start, ``close()`` stops the clock once the
    last started call has returned. The host's state is read on either
    side of it, outside the clock."""

    def __init__(self, seconds: float, ctx: Context | None = None):
        self.seconds = seconds
        self.ctx = ctx
        self.t0 = self.t1 = None

    def open(self) -> None:
        if self.ctx is not None:
            self.ctx.host["open"] = host_state()
        self.t0 = time.perf_counter()

    def due(self) -> bool:
        return time.perf_counter() - self.t0 < self.seconds

    def close(self) -> float:
        self.t1 = time.perf_counter()
        if self.ctx is not None:
            self.ctx.host["close"] = host_state()
        return self.t1 - self.t0


class CallClock:
    """The window of the index cells: the time of the calls alone. Work the
    benchmark does between calls (writing the next repository) stays off
    the clock; ``due()`` says whether the calls so far have taken less than
    ``seconds``; ``timed()`` times one call and keeps its interval."""

    def __init__(self, seconds: float, ctx: Context | None = None):
        self.seconds = seconds
        self.ctx = ctx
        self.spent = 0.0
        self.intervals: list[tuple[int, int]] = []     # time.time_ns of each call

    def open(self) -> None:
        if self.ctx is not None:
            self.ctx.host["open"] = host_state()

    def due(self) -> bool:
        return self.spent < self.seconds

    @contextlib.contextmanager
    def timed(self):
        t, t_ns = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.spent += time.perf_counter() - t
            self.intervals.append((t_ns, time.time_ns()))

    def close(self) -> float:
        if self.ctx is not None:
            self.ctx.host["close"] = host_state()
        return self.spent
