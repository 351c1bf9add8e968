"""The device mesh (port of ``codesearch_tpu/parallel/mesh.py``).

The serving mesh is a device list held by one process: a ``[n_data,
n_model]`` grid of ``torch.device``s with the JAX mesh's axis names. The
corpus shards its rows over the "data" axis, shard ``i`` on the ``i``-th
device of that axis. A device may repeat: ``[cuda:0] * 4`` puts four shards
on one card, and the CPU tests' ``[cpu] * 8`` stands for the JAX tests'
eight virtual CPU devices.

There is no process group. The JAX read plane is one controller driving
every chip; NCCL refuses two ranks on one GPU, so a process group could
never put two shards on one card; and gloo cannot gather CUDA tensors. Each
shard's candidates are copied to the lead device (the first of the grid)
instead, where the merge runs.
"""

from __future__ import annotations

import os

import torch


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``[n_data, n_model]`` grid of devices, all CPU or all CUDA."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        rows = [list(r) for r in devices]
        n_model = len(rows[0]) if rows else 0
        if not n_model or any(len(r) != n_model for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        types = {torch.device(d).type for r in rows for d in r}
        if len(types) != 1 or not types <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's devices must be all CPU or all CUDA, got {sorted(types)}")
        self.devices = [[_device(d) for d in r] for r in rows]
        self.shape = {"data": len(rows), "model": n_model}

    @property
    def shard_devices(self) -> list[torch.device]:
        """The "data" axis: shard ``i`` of the corpus lives on entry ``i``."""
        return [r[0] for r in self.devices]

    @property
    def lead(self) -> torch.device:
        """Where queries are embedded, candidates merged and BM25 runs."""
        return self.devices[0][0]

    @property
    def distinct(self) -> list[torch.device]:
        """The data axis's devices, each once, in order."""
        return list(dict.fromkeys(self.shard_devices))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.shard_devices]})"


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """A mesh with axes ("data", "model") over ``devices`` (default: every
    CUDA device), ``n_data`` of them on the data axis (default: all)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a {n_data} x {n_model} mesh needs more than {len(devices)} devices")
    return Mesh([devices[i * n_model:(i + 1) * n_model] for i in range(n_data)])


# ---------------------------------------------------------------------------
# product-wide corpus mesh (one "data" axis over every CUDA device)
# ---------------------------------------------------------------------------
# VectorStore, FtsStore and the embedding backends consult this to decide
# placement; one device is the None case. Tests install a mesh by setting
# ``_corpus_mesh`` (with ``_corpus_mesh_tried``) and restore it afterwards.

_corpus_mesh: Mesh | None = None
_corpus_mesh_tried = False


def corpus_mesh() -> Mesh | None:
    """The mesh the product shards over: every CUDA device on the "data"
    axis, or None with fewer than two CUDA devices or when
    ``CODESEARCH_SINGLE_DEVICE`` is set."""
    global _corpus_mesh, _corpus_mesh_tried
    if _corpus_mesh_tried:
        return _corpus_mesh
    _corpus_mesh_tried = True
    if os.environ.get("CODESEARCH_SINGLE_DEVICE"):
        return None
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    _corpus_mesh = make_mesh()
    return _corpus_mesh


def reset_corpus_mesh() -> None:
    """Testing hook: re-evaluate device availability / env overrides."""
    global _corpus_mesh, _corpus_mesh_tried
    _corpus_mesh = None
    _corpus_mesh_tried = False


def mesh_for(device) -> Mesh | None:
    """The corpus mesh for a store or backend on ``device``: None when there
    is none or its devices are of another type (a store opened on the CPU
    never takes a CUDA mesh)."""
    mesh = corpus_mesh()
    if mesh is None or mesh.lead.type != torch.device(device).type:
        return None
    return mesh
