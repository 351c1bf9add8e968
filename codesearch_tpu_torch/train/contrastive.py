"""Contrastive (InfoNCE) training of an encoder (port of
``codesearch_tpu/train/contrastive.py``), on one device.

The encoder is ``models.encoder.BertEncoder`` in its trainable form (f32
master weights, bf16 forward, any registry family); the optimizer is
``torch.optim.AdamW`` with optax ``adamw``'s defaults (``weight_decay`` 1e-4,
not torch's 1e-2). A step encodes the queries and the documents, takes the
symmetric InfoNCE of their in-batch [B, B] logits at temperature 0.05,
backpropagates (kernels d and e forward, ``reference_attention``
recomputed backward) and updates in place. The JAX package's mesh rules
(``param_shardings``, ``_rule_for``: tensor-parallel QKV and MLP weights)
wait for ``parallel/``.
"""

from __future__ import annotations

import torch

from ..models.encoder import BertEncoder, cached_init_params
from ..models.registry import ArchConfig
from .hash_finetune import info_nce

ADAMW_WEIGHT_DECAY = 1e-4    # optax.adamw's default


def make_train_state(cfg: ArchConfig, device=None, seed: int = 0,
                     learning_rate: float = 1e-4):
    """(trainable encoder from the JAX package's ``init_params(PRNGKey(seed),
    cfg)``, regenerated or read from the init cache, its AdamW optimizer)
    on ``device``."""
    model = BertEncoder(cfg, cached_init_params(cfg, seed), device=device, trainable=True)
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY)
    return model, opt


def info_nce_loss(model: BertEncoder, batch: dict, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives of a ``data.batches``
    batch (tensors on the model's device)."""
    q_emb = model.encode(batch["query_ids"], batch["query_mask"])
    d_emb = model.encode(batch["doc_ids"], batch["doc_mask"])
    return info_nce(q_emb, d_emb, temperature)


def make_train_step(cfg: ArchConfig, optimizer: torch.optim.Optimizer):
    """``step(model, batch) -> loss``: one InfoNCE step on a batch of numpy
    or torch [B, L] arrays, the model and ``optimizer`` updated in place;
    the loss stays on the device (a 0-d tensor)."""
    def step(model: BertEncoder, batch: dict) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        dev = model.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss = info_nce_loss(model, batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
