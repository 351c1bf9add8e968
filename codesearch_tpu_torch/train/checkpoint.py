"""Training checkpoints (port of ``codesearch_tpu/train/checkpoint.py``).

Parameters, optimizer state and the step counter, saved with ``torch.save``
as one file ``<ckpt_dir>/step_%08d`` (a temporary name, then
``os.replace``, so a reader never sees half a file). The JAX package writes
orbax directories under the same names; the two formats are not shared, and
neither is part of the index format.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


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
