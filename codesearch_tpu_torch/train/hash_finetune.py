"""Contrastive fine-tuning of the hash-embedder table (port of
``codesearch_tpu/train/hash_finetune.py``).

The weights-free ``code-hash-*`` models are one [buckets, d] table, a
trainable embedding matrix. Fine-tuning on pairs mined from the indexed
corpus (``train.data.mine_pairs``) aligns query words with code words,
which a random projection cannot do: InfoNCE with in-batch negatives over
``embed_features`` (a row gather, a weighted sum, an L2 norm), full-batch
steps on the table's device.

The table trains as a dense f32 tensor under ``torch.optim.Adam`` with
optax's ``adam`` defaults. Its gradient stays dense (no ``sparse=True``, no
``SparseAdam``): optax decays both moments of every row at every step, so a
row keeps moving after its last gradient, and a sparse update would train a
different table.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.hash_embedder import batch_features, embed_features
from ..utils.logger import get_logger
from .data import Pair

log = get_logger("hash_finetune")


def _featurize_pairs(pairs: list[Pair], max_tokens: int = 128):
    q_ids, q_ws = batch_features([p.query for p in pairs], max_tokens)
    d_ids, d_ws = batch_features([p.doc for p in pairs], max_tokens)
    return q_ids, q_ws, d_ids, d_ws


def info_nce(q: torch.Tensor, d: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives: the mean of the query ->
    doc and doc -> query cross-entropies of ``q @ d.T / temperature``."""
    logits = (q @ d.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0


def finetune_table(
    table: torch.Tensor,
    pairs: list[Pair],
    epochs: int = 20,
    batch_size: int = 64,
    learning_rate: float = 0.5,
    temperature: float = 0.1,
    seed: int = 0,
):
    """Returns (the trained table in bf16, rounded to nearest even, on the
    table's device; the per-epoch mean losses). Batches follow
    ``np.random.default_rng(seed)`` as the JAX package's do; fewer than 4
    pairs train nothing."""
    if len(pairs) < 4:
        return table, []
    dev = table.device
    tbl = torch.nn.Parameter(table.detach().to(torch.float32).clone())
    opt = torch.optim.Adam([tbl], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    eff_bs = min(batch_size, len(pairs))
    for _epoch in range(epochs):
        order = rng.permutation(len(pairs))
        epoch_losses = []
        for i in range(0, len(order) - eff_bs + 1, eff_bs):
            batch = [pairs[j] for j in order[i : i + eff_bs]]
            q_ids, q_ws, d_ids, d_ws = (torch.from_numpy(a).to(dev)
                                        for a in _featurize_pairs(batch))
            loss = info_nce(embed_features(tbl, q_ids, q_ws),
                            embed_features(tbl, d_ids, d_ws), temperature)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            epoch_losses.append(float(loss.detach()))
        if epoch_losses:
            losses.append(float(np.mean(epoch_losses)))
    log.info("hash finetune: %d pairs, loss %.4f → %.4f",
             len(pairs), losses[0] if losses else 0, losses[-1] if losses else 0)
    return tbl.detach().to(torch.bfloat16), losses
