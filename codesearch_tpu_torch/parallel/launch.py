"""A single-host launcher for the training mesh.

``spawn_ranks(n_data, n_model, fn, args, init_dir=...)`` starts ``n_data *
n_model`` processes with the ``spawn`` start method. Each joins the process
group through a ``file://`` store under ``init_dir`` (no TCP port to
collide with another run), builds its
``TrainMesh`` with ``init_train_mesh``, calls ``fn(mesh, *args)`` and
leaves the group. ``fn`` and ``args`` are pickled: ``fn`` is a module-level
function that a fresh interpreter can import (a child imports ``fn``'s
module and this package, nothing else of the parent). The launcher returns
every rank's result in rank order, and raises on any rank's failure or when
``timeout`` passes, ending every child either way. A result is pickled
by value (a tensor's data copied), so it outlives the rank.

The device is ``resolve_device``'s: no request means CUDA (and raises
when there is none), the CPU only when named. A rank on CUDA takes card
``rank % device_count`` (a bare ``"cuda"``) or the card named; the CUDA
kernels are built once, by the launcher, before any rank starts, into the
build directory the ranks then load from (``ops._build``). The backend
follows the device: NCCL when every rank has a card of its own, gloo on the
CPU. Ranks that share a card (NCCL refuses two ranks on one GPU) take gloo
only when the caller names it. A rank on the CPU takes ``cpu_count / world``
threads. Every rank is on this host, so gloo talks over the loopback
interface (``GLOO_SOCKET_IFNAME=lo`` unless the environment names another).

``train_runs`` is the body of a rank that trains: contrastive steps of a
sharded encoder over global batches, with what a test or a check of the
mesh reads back (rank 0's first-step gradients and final parameters, the
step times, a checkpoint saved and resumed).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback
import uuid
from pathlib import Path

import torch

from ..utils.device import resolve_device


def _rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, the CUDA device named, or card
    ``rank % device_count`` for a bare ``"cuda"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _backend_for(device: torch.device, world: int) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, gloo on the
    CPU; ranks sharing a card must name their backend."""
    if device.type == "cpu":
        return "gloo"
    cards = torch.cuda.device_count() if device.index is None else 1
    if cards < world:
        raise ValueError(f"{world} ranks on {cards} CUDA device(s): NCCL takes one card a "
                         "rank; pass backend='gloo' to share a card")
    return "nccl"


def _rank_main(rank, n_data, n_model, backend, device, init_method, fn, args, results):
    try:
        from .train_mesh import init_train_mesh

        world = n_data * n_model
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = _rank_device(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        mesh = init_train_mesh(n_data, n_model, backend=backend, init_method=init_method,
                               rank=rank, world_size=world, device=dev)
        try:
            out = fn(mesh, *args)
        finally:
            mesh.destroy()
        # pickled here, by value: the queue's own pickler would share a
        # tensor's memory through a handle that dies with this process
        results.put((rank, None, pickle.dumps(out)))
    except BaseException:   # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))


def spawn_ranks(n_data: int, n_model: int, fn, args=(), *, init_dir, device=None,
                backend: str | None = None, timeout: float = 600.0) -> list:
    """``[fn(mesh, *args) for each rank]``, computed by ``n_data *
    n_model`` spawned processes on a ``[n_data, n_model]`` mesh."""
    world = n_data * n_model
    dev = torch.device("cuda") if device is None else torch.device(device)
    resolve_device(dev)             # raises when CUDA is asked for and there is none
    if backend is None:
        backend = _backend_for(dev, world)
    if dev.type == "cuda":
        from ..ops import _build

        _build.build()
    init_dir = Path(init_dir).resolve()
    init_dir.mkdir(parents=True, exist_ok=True)
    store = init_dir / f"store-{uuid.uuid4().hex}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(r, n_data, n_model, backend, str(dev), f"file://{store}",
                               fn, tuple(args), results))
             for r in range(world)]
    out: dict = {}
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                rank, error, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"{', '.join(dead)} ended without a result "
                                       f"(exit codes {[p.exitcode for p in procs]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} gave no "
                                       f"result within {timeout} s")
                continue
            if error is not None:
                raise RuntimeError(f"rank {rank} of {n_data} x {n_model} failed:\n{error}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in started:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        store.unlink(missing_ok=True)
    return [out[r] for r in range(world)]


def train_runs(mesh, runs: list[dict]) -> list[dict]:
    """The body of a rank that trains, for ``spawn_ranks``: for each run in
    turn (``cfg`` and global ``batches``; optionally ``learning_rate``, and
    ``ckpt_dir`` with ``resume_step`` to resume from and ``save_step`` to
    save after, steps counting from 1), contrastive steps from
    ``make_sharded_train_state`` (seed 0). Returns per run the losses,
    each step's wall ms (the device synchronised) and, on rank 0 (None
    elsewhere), the JAX-layout first-step gradients and final parameters."""
    from ..train import checkpoint, contrastive

    out = []
    for run in runs:
        cfg, batches, ckpt = run["cfg"], run["batches"], run.get("ckpt_dir")
        model, opt = contrastive.make_sharded_train_state(
            cfg, mesh, learning_rate=run.get("learning_rate", 1e-4))
        done = 0
        if run.get("resume_step") is not None:
            done = checkpoint.restore_train_state(ckpt, run["resume_step"], model, opt)
        step = contrastive.make_train_step(cfg, opt, mesh)
        res: dict = {"losses": [], "step_ms": [], "grads": None}
        for batch in batches:
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            t0 = time.perf_counter()
            res["losses"].append(float(step(model, batch)))
            res["step_ms"].append((time.perf_counter() - t0) * 1000)
            done += 1
            if len(res["losses"]) == 1:
                res["grads"] = model.gather_params(grads=True)
            if run.get("save_step") == done:
                checkpoint.save_train_state(ckpt, done, model, opt)
        res["params"] = model.gather_params()
        out.append(res)
    return out
