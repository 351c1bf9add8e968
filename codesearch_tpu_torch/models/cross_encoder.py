"""Cross-encoder reranker model on torch (port of
``codesearch_tpu/models/cross_encoder.py``; Jina-reranker-v1-turbo class).

All (query, doc) pairs score in one batched forward on the device: a BERT
encoder (``models/encoder.py``) over ``[CLS] query [SEP] doc [SEP]`` with
segment ids, the CLS row through the ``tanh`` pooler (when the checkpoint
has one) and the linear classifier, then a sigmoid. Absolute-position
checkpoints (the one ``codesearch train --cross-encoder`` writes) run
attention kernel d on CUDA; ALiBi checkpoints (the JinaBERT-v2 family) run
the composed biased attention.

The architecture is read from the checkpoint's own ``config.json``; without
one it is ``CROSS_ENCODER_ARCH``. Without local weights (none can be
downloaded) pair scores come from the hash embedder's cosine, a bi-encoder
proxy, and ``mode`` says which path ran.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logger import get_logger
from .registry import ArchConfig
from .tokenizer import load_tokenizer

# fallback shape when a checkpoint ships without config.json (BERT-small
# class); with a config.json present this is fully overridden
CROSS_ENCODER_ARCH = ArchConfig(
    vocab_size=30522, hidden=384, layers=6, heads=12, intermediate=1536,
    max_len=512, pooling="cls",
)
LOCAL_CROSS_ENCODER = "local-cross-encoder"
MODE_MODEL = "cross-encoder"
MODE_PROXY = "proxy-bi-encoder"


def arch_from_hf_config(model_dir: Path) -> ArchConfig | None:
    """Build an ArchConfig from an HF BertConfig-style config.json. Returns
    None when the file is absent; raises ValueError for architectures the
    encoder cannot run (so stale indexes aren't silently mis-ranked)."""
    p = model_dir / "config.json"
    if not p.exists():
        return None
    raw = json.loads(p.read_text())
    pos = raw.get("position_embedding_type", "absolute")
    if pos not in ("absolute", "alibi"):
        raise ValueError(f"unsupported position_embedding_type: {pos!r}")
    act = raw.get("hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_python"):
        raise ValueError(f"unsupported hidden_act: {act!r}")
    return ArchConfig(
        vocab_size=int(raw.get("vocab_size", 30522)),
        hidden=int(raw.get("hidden_size", 384)),
        layers=int(raw.get("num_hidden_layers", 6)),
        heads=int(raw.get("num_attention_heads", 12)),
        intermediate=int(raw.get("intermediate_size", 1536)),
        max_len=min(int(raw.get("max_position_embeddings", 512)), 8192),
        type_vocab_size=max(int(raw.get("type_vocab_size", 2)), 1),
        layer_norm_eps=float(raw.get("layer_norm_eps", 1e-12)),
        pooling="cls",
        position_type=pos,
    )


class CrossEncoder:
    """The reranker model on ``device``: ``<models_dir>/<name>`` when it
    holds ``model.safetensors``, else ``<models_dir>/local-cross-encoder``
    (a locally trained one), else the bi-encoder proxy."""

    def __init__(self, models_dir: Path | None = None,
                 name: str = "jina-reranker-v1-turbo-en", device=None):
        from . import encoder as enc

        log = get_logger("cross_encoder")
        self.device = resolve_device(device)
        self.cfg = CROSS_ENCODER_ARCH
        self.name = name
        model_dir = (models_dir / name) if models_dir is not None else None
        st = model_dir / "model.safetensors" if model_dir is not None else None
        if (st is None or not st.exists()) and models_dir is not None:
            # zero-egress fallback chain: a cross-encoder trained locally on
            # mined pairs ranks above the bi-encoder proxy; a downloaded
            # checkpoint still wins
            local = models_dir / LOCAL_CROSS_ENCODER
            if (local / "model.safetensors").exists():
                model_dir = local
                st = local / "model.safetensors"
                self.name = LOCAL_CROSS_ENCODER
        if st is not None and st.exists():
            try:
                cfg = arch_from_hf_config(model_dir)
                if cfg is not None:
                    self.cfg = cfg
            except ValueError as e:
                log.warning("reranker %s unusable (%s); using bi-encoder proxy", name, e)
                st = None
        self.tokenizer = load_tokenizer(
            model_dir if model_dir is not None and model_dir.exists() else None,
            lowercase=True, max_len=self.cfg.max_len, vocab_size=self.cfg.vocab_size)
        self.pretrained = st is not None and st.exists()
        self.encoder = self._head = self._proxy = None
        if self.pretrained:
            tensors = enc.read_safetensors(st, self.device)
            self.encoder = enc.BertEncoder(self.cfg, enc.checkpoint_params(tensors, self.cfg),
                                           device=self.device)
            self._head = self._load_head(tensors)
            del tensors             # the checkpoint's bytes on the device
        else:
            from .hash_embedder import HashEmbedder

            self._proxy = HashEmbedder(384, device=self.device)

    @property
    def mode(self) -> str:
        """'cross-encoder' (real batched pair forward) or
        'proxy-bi-encoder' (zero-egress cosine fallback)."""
        return MODE_MODEL if self.pretrained else MODE_PROXY

    @staticmethod
    def _load_head(tensors: dict) -> dict:
        """The pooler (None when absent) and classifier of a checkpoint's
        tensors (``read_safetensors``) as new f32 tensors on their device."""
        def grab(*names):
            for n in names:
                if n in tensors:
                    return tensors[n].to(torch.float32, copy=True)
            return None

        return {"pooler_w": grab("bert.pooler.dense.weight", "pooler.dense.weight"),
                "pooler_b": grab("bert.pooler.dense.bias", "pooler.dense.bias"),
                "cls_w": grab("classifier.weight"), "cls_b": grab("classifier.bias")}

    def score_pairs(self, query: str, docs: list[str]) -> np.ndarray:
        """Sigmoid relevance scores for all (query, doc) pairs, one batch."""
        if not docs:
            return np.zeros((0,), np.float32)
        if not self.pretrained:
            q = self._proxy.embed_texts([query])[0]
            d = self._proxy.embed_texts(docs)
            return _sigmoid(4.0 * (d @ q))  # map cosine to (0,1) with slope
        return self._score_pairs_model(query, docs)

    def pair_batch(self, query: str, docs: list[str]):
        """[n, S] ids, token types and mask of ``[CLS] q [SEP] d [SEP]`` pairs
        (the doc's own CLS dropped; segment 1 when the model has token types),
        cut at ``max_len`` and padded to a power of two from 16."""
        q_ids = self.tokenizer.encode(query).ids
        seg_b = 1 if self.cfg.type_vocab_size > 1 else 0
        rows = []
        for d in docs:
            d_ids = self.tokenizer.encode(d).ids[1:]
            rows.append(((q_ids + d_ids)[: self.cfg.max_len],
                         ([0] * len(q_ids) + [seg_b] * len(d_ids))[: self.cfg.max_len]))
        longest = max(len(ids) for ids, _ in rows)
        max_len = min(1 << max(4, (longest - 1).bit_length()), self.cfg.max_len)
        ids = np.zeros((len(docs), max_len), np.int32)
        tt = np.zeros((len(docs), max_len), np.int32)
        mask = np.zeros((len(docs), max_len), np.int32)
        for i, (a, b) in enumerate(rows):
            n = min(len(a), max_len)
            ids[i, :n], tt[i, :n], mask[i, :n] = a[:n], b[:n], 1
        return ids, tt, mask

    @torch.inference_mode()
    def _score_pairs_model(self, query: str, docs: list[str]) -> np.ndarray:
        ids, tt, mask = (torch.from_numpy(a).to(self.device)
                         for a in self.pair_batch(query, docs))
        hidden = self.encoder.encode_hidden(ids, mask, token_type_ids=tt)   # [n, S, H]
        cls = hidden[:, 0, :].float()
        h = self._head
        pooled = cls if h["pooler_w"] is None \
            else torch.tanh(cls @ h["pooler_w"].T + h["pooler_b"])
        logits = pooled @ h["cls_w"].T + h["cls_b"]     # [n, 1]
        return _sigmoid(logits[:, 0].cpu().numpy())


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return (1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))).astype(np.float32)
