"""Embedding service on torch (port of ``codesearch_tpu/embed/service.py``).

The facade, its three cache layers and the chunk/query batching are the JAX
package's, reused by subclassing; the backend that turns texts into vectors
is the hash embedder on ``device``. BERT-family models need the attention
kernels, which are not ported yet: asking for one raises rather than
substituting another model.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from codesearch_tpu.embed.cache import (
    PersistentEmbeddingCache,
    default_memory_cache,
    default_query_cache,
)
from codesearch_tpu.embed.service import EmbeddingService as _HostEmbeddingService
from codesearch_tpu.models.registry import DEFAULT_MODEL, ModelSpec, parse_model
from codesearch_tpu.utils.constants import get_embedding_cache_dir

from ..models.hash_embedder import HashEmbedder, batch_features, embed_features
from ..utils.device import to_host

# texts per device call: bounds the [B, T, d] f32 gather of embed_features
# (at most 1024 x 512 x 384 x 4 B = 0.8 GB)
EMBED_BATCH = 1024


class _HashBackend:
    """Hash-model backend: host featurization, device gather + weighted sum."""

    def __init__(self, spec: ModelSpec, table_path: Path | None = None, device=None):
        self.spec = spec
        self.model = HashEmbedder(spec.dims, table_path=table_path, device=device)
        self.pretrained = True
        self.mesh = None

    def embed_async(self, texts: list[str], half_transfer: bool = False):
        """Featurize and launch now; the returned callable waits for the
        device and returns [N, dims] f32. ``half_transfer`` rounds the
        vectors to fp16 on the device before the copy (the store keeps fp16
        rows anyway)."""
        if not texts:
            return lambda: np.zeros((0, self.spec.dims), np.float32)
        dev = self.model.device
        outs = []
        for a in range(0, len(texts), EMBED_BATCH):
            ids, ws = batch_features(texts[a:a + EMBED_BATCH])
            out = embed_features(self.model.table, torch.from_numpy(ids).to(dev),
                                 torch.from_numpy(ws).to(dev))
            outs.append(out.half() if half_transfer else out)
        vecs = torch.cat(outs)
        return lambda: to_host(vecs)[0].astype(np.float32)

    def embed(self, texts: list[str]) -> np.ndarray:
        return self.embed_async(texts)()


class EmbeddingService(_HostEmbeddingService):
    """Public embedding facade of the port. ``db_path`` enables a
    fine-tuned table at ``<db>/hash_table.npz``."""

    def __init__(self, model: str | ModelSpec = DEFAULT_MODEL,
                 cache_dir: Path | None = None, use_persistent_cache: bool = True,
                 db_path: Path | None = None, device=None):
        spec = model if isinstance(model, ModelSpec) else parse_model(model)
        if spec is None:
            raise ValueError(f"unknown model: {model!r}")
        if spec.kind != "hash":
            raise NotImplementedError(
                f"model {spec.short_name!r} is a BERT-family encoder; the port "
                "runs only hash models until the attention kernels are ported "
                "(ROADMAP.md Queue 1: BERT with attention)")
        self.spec = spec
        table_path = None
        if db_path is not None and (Path(db_path) / "hash_table.npz").exists():
            table_path = Path(db_path) / "hash_table.npz"
        self.backend = _HashBackend(spec, table_path=table_path, device=device)
        self.trained_table = table_path is not None
        self.mem_cache = default_memory_cache()
        self.query_cache = default_query_cache()
        self.persistent = None
        if use_persistent_cache:
            # the port's vectors come from its own arithmetic: keep them in a
            # cache of their own, apart from the JAX package's
            cache_name = spec.short_name + "-torch"
            if self.trained_table:
                from codesearch_tpu.utils.hashing import sha256_file

                cache_name += "-t" + sha256_file(table_path)[:12]
            pdir = cache_dir or get_embedding_cache_dir(cache_name)
            self.persistent = PersistentEmbeddingCache(pdir, spec.dims)
