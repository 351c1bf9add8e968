"""The training mesh over ``torch.distributed`` (the port of the ("data",
"model") mesh that ``codesearch_tpu/train/contrastive.py`` shards its step
over).

A training mesh is a ``[n_data, n_model]`` grid of processes, one rank a
process, numbered as JAX's ``make_mesh`` lays its devices out: rank
``data * n_model + model``. ``init_train_mesh`` joins the process group and
builds one group per row of the grid (the ranks of a "model" axis) and one
per column (the ranks of a "data" axis) with ``dist.new_group``, every rank
building every group in the same order.

Where JAX's GSPMD inserts the collectives, the encoder calls them by hand,
as small ``torch.autograd.Function``s:

- ``copy_to_model``: identity forward, sum over "model" backward (before a
  column-parallel product, or a slice of a replicated tensor);
- ``reduce_from_model``: sum over "model" forward, identity backward (after
  a row-parallel product, or the vocab-parallel lookup). Not
  ``torch.distributed.nn.functional.all_reduce``: its backward sums again,
  which makes every gradient upstream ``n_model`` times too large;
- ``gather_from_data``: the global batch's rows from each data rank's, its
  backward each rank's own rows;
- ``all_reduce_grads``: every gradient summed over "data".

Every collective is an all_reduce in f32 (then cast back to the input's
dtype): a one-device bf16 product accumulates in f32 and rounds once, and a
bf16 sum of partial products would round again at every rank. The partial
products themselves are f32 products of bf16 operands, which TF32 holds
exactly, so they run with TF32 allowed (``row_parallel``) whatever the
process's setting. The data
gather and the parameter gathers are all_reduces of zero-filled buffers into
which a rank writes its own part: exact, and one code path for NCCL and for
gloo on the CPU or on the card (gloo gathers no CUDA tensors).

How parameters lie on the mesh (``_rule_for``, ``param_shardings``: the
JAX package's rule, by name): ``q_w``, ``k_w``, ``v_w``, ``mlp_in_w`` and
their biases column-parallel; ``o_w`` and ``mlp_out_w`` row-parallel;
``word`` split by vocabulary rows; everything else replicated.
``shard_params`` takes a rank's shards of a parameter tree.
"""

from __future__ import annotations

from dataclasses import dataclass

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass
class TrainMesh:
    """This process's place on a ``[n_data, n_model]`` grid of ranks, its
    axes' process groups and its device (``resolve_device``'s: no request
    means CUDA, the CPU only when named). A mesh made by hand (no groups)
    only lays parameters out (``shard_params``); the collectives need one
    from ``init_train_mesh``."""

    n_data: int
    n_model: int
    rank: int = 0
    device: torch.device | str | None = None
    data_group: object = None
    model_group: object = None

    def __post_init__(self):
        if self.n_data < 1 or self.n_model < 1 or not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} is not on a {self.n_data} x {self.n_model} mesh")
        self.device = resolve_device(self.device)

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the "data" axis (its batch rows)."""
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the "model" axis (its shards)."""
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    def group(self, axis: str):
        group = {"data": self.data_group, "model": self.model_group}[axis]
        if group is None:
            raise RuntimeError("this mesh has no process groups: make it with init_train_mesh")
        return group

    def destroy(self) -> None:
        """Leave the process group (every group of the mesh with it)."""
        dist.destroy_process_group()


def init_train_mesh(n_data: int, n_model: int, *, init_method: str, rank: int,
                    world_size: int, device=None, backend: str | None = None) -> TrainMesh:
    """Join the process group (``init_method`` a ``file://`` or ``tcp://``
    address) as ``rank`` of ``world_size`` = ``n_data * n_model`` on
    ``device`` (``resolve_device``: CUDA unless the CPU is named) and build
    the axes' groups. ``backend`` defaults to the device's: NCCL on CUDA,
    gloo on the CPU. Every rank calls it with the same grid."""
    if world_size != n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"not {world_size}")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    groups = {}
    for d in range(n_data):         # the rows: one "model" axis each
        ranks = [d * n_model + m for m in range(n_model)]
        groups[("model", d)] = dist.new_group(ranks)
    for m in range(n_model):        # the columns: one "data" axis each
        ranks = [d * n_model + m for d in range(n_data)]
        groups[("data", m)] = dist.new_group(ranks)
    mesh = TrainMesh(n_data, n_model, rank, device)
    mesh.model_group = groups[("model", mesh.data_rank)]
    mesh.data_group = groups[("data", mesh.model_rank)]
    return mesh


def barrier(mesh: TrainMesh) -> None:
    """Wait for every rank (an all_reduce on the mesh's device, which NCCL
    and gloo both take)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device))


# ---------------------------------------------------------------------------
# where each parameter lies
# ---------------------------------------------------------------------------

def _rule_for(path: tuple, leaf=None) -> tuple:
    """Partition of a parameter by its name (the last key of ``path``), as
    the JAX package's ``PartitionSpec``: column parallel on "model" for the
    in-projections, row parallel for the out-projections, the word table by
    vocabulary rows, ``()`` (replicated) for the rest."""
    name = path[-1] if path else ""
    if name in ("q_w", "k_w", "v_w", "mlp_in_w"):
        return (None, "model")          # column parallel
    if name in ("o_w", "mlp_out_w"):
        return ("model", None)          # row parallel
    if name in ("q_b", "k_b", "v_b", "mlp_in_b"):
        return ("model",)
    if name == "word":
        return ("model", None)          # vocab-sharded embedding table
    return ()                           # replicated (norms, positions, o_b...)


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(params: dict, mesh: TrainMesh) -> dict:
    """The partition of every parameter of a JAX-layout tree (``q_w``,
    ``k_w``, ``v_w`` apart), e.g. ``(None, "model")``; raises ``ValueError``
    naming the parameter whose sharded dimension does not divide by the
    mesh's axis, as JAX's ``device_put`` refuses it."""
    def spec(path, leaf):
        out = _rule_for(path, leaf)
        for dim, axis in enumerate(out):
            if axis is not None and leaf.shape[dim] % mesh.shape[axis]:
                raise ValueError(
                    f"{'.'.join(map(str, path))}: dimension {dim} of {tuple(leaf.shape)} does "
                    f"not divide by the {axis!r} axis ({mesh.shape[axis]})")
        return out

    return _tree_map(spec, params)


def split_dim(spec: tuple) -> int | None:
    """The dimension a partition splits over "model" (None: replicated)."""
    return spec.index("model") if "model" in spec else None


def take_shard(t, dim: int | None, mesh: TrainMesh, blocks: int = 1):
    """This rank's shard of a full array or tensor ``t`` split over "model"
    along ``dim``: with ``blocks`` > 1 (a fused QKV), the concatenation of
    this rank's part of each of ``blocks`` equal blocks."""
    if dim is None:
        return t
    n, m = mesh.n_model, mesh.model_rank
    size = t.shape[dim] // (blocks * n)
    if isinstance(t, torch.Tensor):
        parts = [t.narrow(dim, (b * n + m) * size, size) for b in range(blocks)]
        return parts[0] if blocks == 1 else torch.cat(parts, dim)
    parts = np.split(t, blocks * n, axis=dim)[m::n]
    return np.ascontiguousarray(np.concatenate(parts, axis=dim))


def shard_params(params: dict, mesh: TrainMesh) -> dict:
    """This rank's shards of a JAX-layout parameter tree (numpy)."""
    param_shardings(params, mesh)       # refuses a split that does not divide
    return _tree_map(lambda path, leaf: take_shard(leaf, split_dim(_rule_for(path)), mesh),
                     params)


def gather_shard(local: torch.Tensor, dim: int | None, mesh: TrainMesh,
                 blocks: int = 1) -> torch.Tensor:
    """The full f32 tensor of every model rank's ``take_shard`` (a
    collective over "model"): each rank writes its part into a zero-filled
    buffer and the buffers are summed."""
    local = local.detach().float()
    if dim is None:
        return local.clone()
    shape = list(local.shape)
    shape[dim] *= mesh.n_model
    full = local.new_zeros(shape)
    n, m = mesh.n_model, mesh.model_rank
    size = local.shape[dim] // blocks
    for b in range(blocks):
        full.narrow(dim, (b * n + m) * size, size).copy_(local.narrow(dim, b * size, size))
    dist.all_reduce(full, group=mesh.group("model"))
    return full


# ---------------------------------------------------------------------------
# the collectives of the step
# ---------------------------------------------------------------------------

def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in f32, cast back to ``t``'s dtype."""
    out = t.to(torch.float32, copy=True)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        b = x.shape[0]
        ctx.rows = (mesh.data_rank * b, b)
        full = x.new_zeros((b * mesh.n_data, *x.shape[1:]), dtype=torch.float32)
        full[mesh.data_rank * b:(mesh.data_rank + 1) * b] = x
        dist.all_reduce(full, group=mesh.group("data"))
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        start, b = ctx.rows
        return grad[start:start + b], None


def copy_to_model(x: torch.Tensor, mesh: TrainMesh) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the "model" axis."""
    return _CopyToModel.apply(x, mesh.group("model"))


def reduce_from_model(x: torch.Tensor, mesh: TrainMesh) -> torch.Tensor:
    """``x`` summed over the "model" axis (in f32, in ``x``'s dtype); its
    gradient as it is."""
    return _ReduceFromModel.apply(x, mesh.group("model"))


def gather_from_data(x: torch.Tensor, mesh: TrainMesh) -> torch.Tensor:
    """[B / n_data, ...] rows of this data rank -> the global [B, ...] in
    data-rank order; the gradient of this rank's rows only."""
    return _GatherFromData.apply(x, mesh)


@contextlib.contextmanager
def _tf32():
    """TF32 allowed for the f32 products inside (bf16 operands, which TF32
    holds exactly: the products are exact, only the order of the f32 sums
    may differ), the process's setting restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _PartialProduct(torch.autograd.Function):
    """``x @ w`` of bf16 operands as an f32 product, forward and backward
    under ``_tf32``; the gradients in the operands' dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _tf32():
            return torch.matmul(x.float(), w.float())

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with _tf32():
            gx = torch.matmul(grad, w.float().t()).to(x.dtype)
            gw = torch.matmul(x.float().reshape(-1, x.shape[-1]).t(),
                              grad.reshape(-1, grad.shape[-1])).to(w.dtype)
        return gx, gw


def row_parallel(x: torch.Tensor, w: torch.Tensor, mesh: TrainMesh) -> torch.Tensor:
    """``x @ w`` with the contraction split over "model" (this rank's
    columns of ``x``, rows of ``w``, a 2-d ``w``): the partial products in
    f32 (TF32 allowed: exact for bf16 operands) summed in f32 and rounded
    once to ``x``'s dtype. On one model rank the product is the one-device
    product (the sum adds nothing)."""
    if mesh.n_model == 1:
        return reduce_from_model(torch.matmul(x, w), mesh)
    return reduce_from_model(_PartialProduct.apply(x, w), mesh).to(x.dtype)


def vocab_parallel_lookup(word: torch.Tensor, ids: torch.Tensor, mesh: TrainMesh) -> torch.Tensor:
    """Rows ``ids`` (already clamped to the global table) of a table split by
    vocabulary rows: this rank's rows where the id is in its range, zeros
    elsewhere, summed over "model"."""
    rows = word.shape[0]
    local = ids - mesh.model_rank * rows
    inside = (local >= 0) & (local < rows)
    out = torch.where(inside[..., None], word[local.clamp(0, rows - 1)], 0.0)
    return reduce_from_model(out, mesh)


def all_reduce_grads(module: torch.nn.Module, mesh: TrainMesh) -> None:
    """Sum every parameter's gradient over the "data" axis (one all_reduce
    of one flat f32 buffer; a parameter without a gradient takes zeros)."""
    params = list(module.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    dist.all_reduce(flat, group=mesh.group("data"))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))
