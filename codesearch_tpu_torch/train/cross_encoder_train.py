"""Cross-encoder training for the neural reranker, with no download (port
of ``codesearch_tpu/train/cross_encoder_train.py``).

``search --rerank`` falls back to a bi-encoder proxy when no cross-encoder
checkpoint is present. This module trains a small real one, a BERT trunk
with the CLS ``tanh`` pooler and a linear head, from scratch on pairs mined
from the indexed corpus, and exports it in the Hugging Face BERT
safetensors layout under ``local-cross-encoder`` in the models cache, where
``models.cross_encoder.CrossEncoder`` of either package finds it.

Training is binary relevance on (query, doc) pairs: the mined pairs are
positives; each query with the next pair's doc is an easy negative and,
when given, one retriever-mined hard negative a pair. The loss is
``binary_cross_entropy_with_logits``, the optimizer ``torch.optim.Adam``
with optax ``adam``'s defaults, one step a batch. The pair layout is the
JAX package's (query ids, doc ids without their CLS, segment ids 0 and 1),
the trunk's init and the head's are the JAX package's bit for bit
(``jax_random``), and the batches follow the same
``np.random.default_rng(seed)`` order.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import jax_random
from ..models.encoder import HF_LAYER_MAP, BertEncoder, init_params
from ..models.registry import ArchConfig
from ..models.tokenizer import load_tokenizer
from ..utils.logger import get_logger
from .data import Pair

log = get_logger("cross_encoder_train")

# the name CrossEncoder falls back to when the default checkpoint is absent
LOCAL_CE_NAME = "local-cross-encoder"

# the JAX package's small trunk for the local reranker
SMALL_CE_CFG = ArchConfig(
    vocab_size=30522, hidden=192, layers=3, heads=6, intermediate=768,
    max_len=256, pooling="cls",
)


def _pair_batch(tok, queries: list[str], docs: list[str], max_len: int):
    """[CLS] query … [SEP] doc … as numpy int32 ids, segment ids (the doc's
    always 1) and mask, padded to a power of two from 16, cut at
    ``max_len``."""
    ids_l, tt_l = [], []
    longest = 0
    for q, d in zip(queries, docs):
        q_ids = tok.encode(q).ids
        d_ids = tok.encode(d).ids[1:]
        ids = (q_ids + d_ids)[:max_len]
        tt = ([0] * len(q_ids) + [1] * len(d_ids))[:max_len]
        ids_l.append(ids)
        tt_l.append(tt)
        longest = max(longest, len(ids))
    longest = min(1 << max(4, (longest - 1).bit_length()), max_len)
    n = len(ids_l)
    ids = np.zeros((n, longest), np.int32)
    tt = np.zeros((n, longest), np.int32)
    mask = np.zeros((n, longest), np.int32)
    for i, (a, b) in enumerate(zip(ids_l, tt_l)):
        L = min(len(a), longest)
        ids[i, :L] = a[:L]
        tt[i, :L] = b[:L]
        mask[i, :L] = 1
    return ids, tt, mask


def init_head(key: tuple[int, int], cfg: ArchConfig) -> dict:
    """The JAX package's ``init_head(key, cfg)`` in numpy, bit for bit: the
    pooler [h, h] and classifier [1, h] in HF orientation ([out, in]),
    ``normal * 0.02`` from the two halves of ``split(key)``, zero biases."""
    k1, k2 = jax_random.split(key, 2)
    h = cfg.hidden
    scale = np.float32(0.02)
    return {
        "pooler_w": jax_random.normal(k1, (h, h)) * scale,
        "pooler_b": np.zeros((h,), np.float32),
        "cls_w": jax_random.normal(k2, (1, h)) * scale,
        "cls_b": np.zeros((1,), np.float32),
    }


class PairHead(nn.Module):
    """The CLS row through the ``tanh`` pooler and the classifier, in f32
    (f32 parameters under the names of ``init_head``)."""

    def __init__(self, head: dict, device):
        super().__init__()
        for name, arr in head.items():
            t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
            self.register_parameter(name, nn.Parameter(t))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        cls = hidden[:, 0, :].float()
        pooled = torch.tanh(cls @ self.pooler_w.T + self.pooler_b)
        return (pooled @ self.cls_w.T + self.cls_b)[:, 0]

    def to_params(self) -> dict:
        return {name: p.detach().cpu().numpy() for name, p in self.named_parameters()}


def train_cross_encoder(
    pairs: list[Pair],
    cfg: ArchConfig = SMALL_CE_CFG,
    epochs: int = 3,
    batch_size: int = 32,
    learning_rate: float = 3e-4,
    seed: int = 0,
    hard_negatives: list[list[str]] | None = None,
    on_epoch=None,
    device=None,
):
    """Returns (the trunk's parameter tree and the head as f32 numpy, in the
    JAX package's names; the tokenizer; the per-epoch mean losses), trained
    on ``device``. ``hard_negatives[i]`` are retriever-confusable documents
    for pair i (``data.mine_hard_negatives``), one a step, cycling across
    epochs."""
    tok = load_tokenizer(None, lowercase=True, max_len=cfg.max_len,
                         vocab_size=cfg.vocab_size)
    encoder = BertEncoder(cfg, init_params(cfg, seed), device=device, trainable=True)
    dev = encoder.device
    head = PairHead(init_head(jax_random.fold_in(jax_random.prng_key(seed), 1), cfg), dev)
    opt = torch.optim.Adam([*encoder.parameters(), *head.parameters()], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    eff_bs = max(2, min(batch_size, len(pairs)))
    for epoch in range(epochs):
        order = rng.permutation(len(pairs))
        epoch_losses = []
        for i in range(0, len(order) - eff_bs + 1, eff_bs):
            take = order[i : i + eff_bs]
            batch = [pairs[j] for j in take]
            qs = [p.query for p in batch]
            docs = [p.doc for p in batch]
            # easy negatives: each query with the next pair's doc
            all_q = qs + qs
            all_d = docs + docs[1:] + docs[:1]
            n_neg = len(batch)
            if hard_negatives is not None:
                for pos, j in enumerate(take):
                    negs = hard_negatives[j]
                    if negs:
                        all_q.append(qs[pos])
                        all_d.append(negs[epoch % len(negs)])
                        n_neg += 1
            ids, tt, mask = (torch.from_numpy(a).to(dev)
                             for a in _pair_batch(tok, all_q, all_d, cfg.max_len))
            labels = torch.cat([torch.ones(len(batch)), torch.zeros(n_neg)]).to(dev)
            logits = head(encoder.encode_hidden(ids, mask, token_type_ids=tt))
            loss = F.binary_cross_entropy_with_logits(logits, labels)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            epoch_losses.append(float(loss.detach()))
        if epoch_losses:
            losses.append(float(np.mean(epoch_losses)))
            log.info("cross-encoder epoch %d/%d: loss %.4f", epoch + 1, epochs, losses[-1])
            if on_epoch is not None:
                on_epoch(epoch + 1, epochs, losses[-1])
    log.info("cross-encoder train: %d pairs, loss %.4f → %.4f", len(pairs),
             losses[0] if losses else 0.0, losses[-1] if losses else 0.0)
    return encoder.to_params(), head.to_params(), tok, losses


def export_cross_encoder(params: dict, head: dict, cfg: ArchConfig, out_dir: Path) -> Path:
    """Write a trunk tree and head (numpy, the JAX package's names) in the
    HF BERT safetensors layout with its ``config.json``, dense kernels
    transposed back to HF's [out, in]; either package's ``CrossEncoder``
    loads it as a downloaded checkpoint."""
    from safetensors.numpy import save_file

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t: dict[str, np.ndarray] = {}

    def put(name, arr):
        t[name] = np.ascontiguousarray(arr, np.float32)

    emb = params["embeddings"]
    put("embeddings.word_embeddings.weight", emb["word"])
    put("embeddings.token_type_embeddings.weight", emb["token_type"])
    put("embeddings.position_embeddings.weight", emb["position"])
    put("embeddings.LayerNorm.weight", emb["ln_scale"])
    put("embeddings.LayerNorm.bias", emb["ln_bias"])
    for i, layer in enumerate(params["layers"]):
        for ours, theirs in HF_LAYER_MAP.items():
            arr = np.asarray(layer[ours])
            put(f"encoder.layer.{i}.{theirs}", arr.T if ours.endswith("_w") else arr)
    put("bert.pooler.dense.weight", head["pooler_w"])
    put("bert.pooler.dense.bias", head["pooler_b"])
    put("classifier.weight", head["cls_w"])
    put("classifier.bias", head["cls_b"])
    tmp = out_dir / "model.safetensors.tmp"
    save_file(t, str(tmp))
    os.replace(tmp, out_dir / "model.safetensors")
    config = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden,
        "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads,
        "intermediate_size": cfg.intermediate,
        "max_position_embeddings": cfg.max_len,
        "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.layer_norm_eps,
        "position_embedding_type": "absolute",
        "hidden_act": "gelu",
        "model_type": "bert",
    }
    (out_dir / "config.json").write_text(json.dumps(config, indent=2))
    return out_dir


def train_and_export(
    pairs: list[Pair],
    models_dir: Path,
    cfg: ArchConfig = SMALL_CE_CFG,
    epochs: int = 3,
    mine_negatives: bool = True,
    neg_depth: int = 4,
    device=None,
    **kw,
) -> tuple[Path, list[float]]:
    """Train on mined pairs (with ``neg_depth`` retriever-mined hard
    negatives a pair unless ``mine_negatives`` is off or ``hard_negatives``
    is given) and install the model under ``local-cross-encoder`` in
    ``models_dir``, where ``search --rerank`` picks it up."""
    if mine_negatives and "hard_negatives" not in kw:
        from .data import mine_hard_negatives

        kw["hard_negatives"] = mine_hard_negatives(pairs, k=neg_depth, device=device)
    params, head, _tok, losses = train_cross_encoder(pairs, cfg=cfg, epochs=epochs,
                                                     device=device, **kw)
    out = export_cross_encoder(params, head, cfg, Path(models_dir) / LOCAL_CE_NAME)
    return out, losses
