"""Training checkpoints (port of ``codesearch_tpu/train/checkpoint.py``).

Parameters, optimizer state and the step counter, saved with ``torch.save``
as one file ``<ckpt_dir>/step_%08d`` (a temporary name, then
``os.replace``, so a reader never sees half a file). The JAX package writes
orbax directories under the same names; the two formats are not shared, and
neither is part of the index format.

``save_train_state``/``restore_train_state`` keep a contrastive training
state (a trainable ``BertEncoder`` and its AdamW) in the one-device layout,
as the JAX package's checkpoint is restorable onto a mesh: from a sharded
model, rank 0 writes the parameters and the Adam moments gathered over
"model"; a model on any mesh, or on one device, restores by taking its own
shards.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ..parallel import train_mesh


def _path(ckpt_dir: Path, step: int) -> Path:
    return Path(ckpt_dir).resolve() / f"step_{step:08d}"


def save_checkpoint(ckpt_dir: Path, step: int, params, opt_state) -> Path:
    """Write ``{"params", "opt_state", "step"}`` (e.g. a module's and an
    optimizer's ``state_dict()``) atomically; returns the file."""
    path = _path(ckpt_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        torch.save({"params": params, "opt_state": opt_state, "step": step}, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def latest_step(ckpt_dir: Path) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(
        int(p.name.removeprefix("step_"))
        for p in d.iterdir()
        if p.name.startswith("step_") and p.name.removeprefix("step_").isdigit()
    )
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: Path, step: int) -> dict:
    """``{"params", "opt_state", "step"}`` of ``step``, its tensors on the
    CPU; ``module.load_state_dict`` and ``optimizer.load_state_dict`` copy
    the parts onto the devices of a fresh state."""
    return torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)


def _param_names(model, optimizer) -> list[str]:
    """The parameter name of each optimizer state index."""
    names = {id(p): name for name, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _moment_keys(state: dict) -> list[str]:
    """The per-element entries of a parameter's optimizer state (AdamW's
    moments; not its 0-d step)."""
    return [k for k, v in state.items() if isinstance(v, torch.Tensor) and v.dim() > 0]


def save_train_state(ckpt_dir: Path, step: int, model, optimizer) -> Path | None:
    """``save_checkpoint`` of a model's parameters and its optimizer's state
    in the one-device layout (gathered over "model" on a mesh: a collective,
    rank 0 writes, every rank waits for it). Returns the file (None on the
    ranks that do not write)."""
    params = model.gather_tensors(dict(model.named_parameters()))
    opt = optimizer.state_dict()
    names = _param_names(model, optimizer)
    state = {i: dict(s) for i, s in opt["state"].items()}
    for key in sorted({k for s in state.values() for k in _moment_keys(s)}):
        full = model.gather_tensors({names[i]: s[key] for i, s in state.items() if key in s})
        for i, s in state.items():
            if full is not None and key in s:
                s[key] = full[names[i]]
    path = None
    if params is not None:
        path = save_checkpoint(ckpt_dir, step, params,
                               {"state": state, "param_groups": opt["param_groups"]})
    if model.mesh is not None:
        train_mesh.barrier(model.mesh)
    return path


def restore_train_state(ckpt_dir: Path, step: int, model, optimizer) -> int:
    """Load a ``save_train_state`` checkpoint into ``model`` and
    ``optimizer``, each tensor this rank's shard of the saved one; returns
    the saved step."""
    ckpt = restore_checkpoint(ckpt_dir, step)
    model.load_state_dict(model.shard_tensors(ckpt["params"]))
    names = _param_names(model, optimizer)
    state = {}
    for i, saved in ckpt["opt_state"]["state"].items():
        state[i] = dict(saved)
        for key in _moment_keys(saved):
            state[i][key] = model.shard_tensors({names[i]: saved[key]})[names[i]].clone()
    optimizer.load_state_dict({"state": state,
                               "param_groups": ckpt["opt_state"]["param_groups"]})
    return ckpt["step"]
