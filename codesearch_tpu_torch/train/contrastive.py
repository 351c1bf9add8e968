"""Contrastive (InfoNCE) training of an encoder (port of
``codesearch_tpu/train/contrastive.py``), on one device or over a
("data", "model") training mesh.

The encoder is ``models.encoder.BertEncoder`` in its trainable form (f32
master weights, bf16 forward, any registry family); the optimizer is
``torch.optim.AdamW`` with optax ``adamw``'s defaults (``weight_decay`` 1e-4,
not torch's 1e-2). A step encodes the queries and the documents, takes the
symmetric InfoNCE of their in-batch [B, B] logits at temperature 0.05,
backpropagates (kernels d and e forward, ``reference_attention``
recomputed backward) and updates in place.

On a mesh (``parallel.train_mesh``: one process a rank, as the JAX package
shards its step with GSPMD) the batch is split over "data" and the
in-batch negatives span the global batch (``gather_from_data``); the
parameters lie as ``_rule_for`` places them over "model" (the sharded
``BertEncoder``); every rank computes the same global loss, its own rows'
gradients, and ``all_reduce_grads`` sums them over "data" before AdamW,
which is elementwise, so sharded Adam equals replicated Adam.
"""

from __future__ import annotations

import torch

from ..models.encoder import BertEncoder, cached_init_params
from ..models.registry import ArchConfig
from ..parallel.train_mesh import (  # noqa: F401  (the JAX module's names)
    TrainMesh,
    _rule_for,
    all_reduce_grads,
    gather_from_data,
    param_shardings,
)
from .hash_finetune import info_nce

ADAMW_WEIGHT_DECAY = 1e-4    # optax.adamw's default
TEMPERATURE = 0.05


def _adamw(model: BertEncoder, learning_rate: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY)


def make_train_state(cfg: ArchConfig, device=None, seed: int = 0,
                     learning_rate: float = 1e-4):
    """(trainable encoder from the JAX package's ``init_params(PRNGKey(seed),
    cfg)``, regenerated or read from the init cache, its AdamW optimizer)
    on ``device``."""
    model = BertEncoder(cfg, cached_init_params(cfg, seed), device=device, trainable=True)
    return model, _adamw(model, learning_rate)


def make_sharded_train_state(cfg: ArchConfig, mesh: TrainMesh, seed: int = 0,
                             learning_rate: float = 1e-4):
    """(this rank's sharded trainable encoder of ``init_params(cfg, seed)``,
    AdamW on its shards) on the mesh's device; ``ValueError`` names a
    parameter whose sharded dimension does not divide by its axis."""
    model = BertEncoder(cfg, cached_init_params(cfg, seed), trainable=True, mesh=mesh)
    return model, _adamw(model, learning_rate)


def info_nce_loss(model: BertEncoder, batch: dict,
                  temperature: float = TEMPERATURE) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives of a ``data.batches``
    batch (tensors on the model's device). A sharded model takes this data
    rank's rows and returns the loss of the global batch, whose rows every
    data rank gathers."""
    q_emb = model.encode(batch["query_ids"], batch["query_mask"])
    d_emb = model.encode(batch["doc_ids"], batch["doc_mask"])
    if model.mesh is not None:
        q_emb, d_emb = gather_from_data(q_emb, model.mesh), gather_from_data(d_emb, model.mesh)
    return info_nce(q_emb, d_emb, temperature)


def data_rows(batch: dict, mesh: TrainMesh) -> dict:
    """This data rank's rows of a global batch; ``ValueError`` when the
    batch does not divide by the "data" axis."""
    out = {}
    for name, t in batch.items():
        b = t.shape[0]
        if b % mesh.n_data:
            raise ValueError(f"batch {name}: {b} rows do not divide by the 'data' axis "
                             f"({mesh.n_data})")
        rows = b // mesh.n_data
        out[name] = t[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
    return out


def make_train_step(cfg: ArchConfig, optimizer: torch.optim.Optimizer,
                    mesh: TrainMesh | None = None):
    """``step(model, batch) -> loss``: one InfoNCE step on a batch of numpy
    or torch [B, L] arrays, the model and ``optimizer`` updated in place;
    the loss stays on the device (a 0-d tensor). With ``mesh`` (the sharded
    model's), ``batch`` is the global batch: the step takes this data rank's
    rows and sums the gradients over "data" before the update."""
    def step(model: BertEncoder, batch: dict) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        if model.mesh is not mesh:
            raise ValueError("the model's mesh is not the step's")
        if mesh is not None:
            batch = data_rows(batch, mesh)
        dev = model.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss = info_nce_loss(model, batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            all_reduce_grads(model, mesh)
        optimizer.step()
        return loss.detach()

    return step
