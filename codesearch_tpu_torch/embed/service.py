"""Embedding service on torch (the port of ``codesearch_tpu/embed/service.py``):
text preparation, batching, device inference, caching.

The bulk-index path of the reference EmbeddingService (src/embed/mod.rs:17-292):
persistent-cache lookup by chunk hash → device inference for misses →
write-back, order-preserving merge. Queries are embedded inside the search
pipeline's one device call (``featurize_queries``). The backend that turns texts into vectors runs
on ``device``: the hash embedder for hash models, the BERT encoder
(``models/encoder.py``, attention kernels d and e on CUDA) for BERT-family
models with absolute positions, tokenized on the host into power-of-two
token buckets. Rotary and ALiBi models raise ``NotImplementedError``
rather than substituting another model.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..chunker import Chunk
from ..models import encoder as enc
from ..models.hash_embedder import HashEmbedder, batch_features, embed_features
from ..models.registry import DEFAULT_MODEL, ModelSpec, parse_model
from ..models.tokenizer import load_tokenizer
from ..utils.constants import get_embedding_cache_dir, get_global_models_cache_dir
from ..utils.device import resolve_device, to_host
from ..utils.hashing import sha256_file
from ..utils.logger import get_logger
from .cache import (
    LruBytesCache,
    PersistentEmbeddingCache,
    default_memory_cache,
)

log = get_logger("embed")

# texts per device call: bounds the [B, T, d] f32 gather of embed_features
# (at most 1024 x 512 x 384 x 4 B = 0.8 GB)
EMBED_BATCH = 1024


# Device batch size: large batches amortize dispatch; env-overridable
# (reference: CODESEARCH_BATCH_SIZE, embedder.rs:249-263).
def _default_batch_size(dims: int) -> int:
    env = os.environ.get("CODESEARCH_BATCH_SIZE")
    if env:
        return max(1, int(env))
    if dims <= 384:
        return 256
    if dims <= 768:
        return 128
    return 64


def prepare_text(chunk: Chunk) -> str:
    """Embedding text: Context / Signature / Name / Documentation / Code
    (behavioral parity with embed/batch.rs:137-181)."""
    parts: list[str] = []
    if chunk.context:
        parts.append("Context: " + " > ".join(chunk.context))
    if chunk.signature:
        parts.append("Signature: " + chunk.signature)
        words = chunk.signature.split()
        if len(words) >= 2:
            name = words[1].split("<")[0].split("(")[0].split("{")[0]
            if name:
                parts.append("Name: " + name)
    if chunk.docstring:
        cleaned = clean_docstring(chunk.docstring)
        if cleaned:
            parts.append("Documentation: " + cleaned)
    parts.append("Code:\n" + chunk.content)
    return "\n".join(parts)


def clean_docstring(doc: str) -> str:
    """Strip comment markers (parity with embed/batch.rs:197-231)."""
    out: list[str] = []
    for line in doc.split("\n"):
        t = line.strip()
        if t == "*/":
            t = ""
        else:
            for prefix in ("///", "//!", "//", "/**", "*", '"'):
                if t.startswith(prefix):
                    t = t[len(prefix):].strip()
                    break
        if t:
            out.append(t)
    result = " ".join(out)
    return result.removesuffix('"').strip()


class _HashBackend:
    """Hash-model backend: host featurization, device gather + weighted sum."""

    def __init__(self, spec: ModelSpec, table_path: Path | None = None, device=None):
        self.spec = spec
        self.model = HashEmbedder(spec.dims, table_path=table_path, device=device)

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


class _BertBackend:
    """BERT-family backend: host tokenization into power-of-two token buckets
    (16..512), device batches of ``_default_batch_size`` texts (256 at
    d <= 384) through ``BertEncoder.encode``. Weights: ``model.safetensors``
    in the models cache when present, else the JAX package's random init,
    regenerated in numpy and cached."""

    def __init__(self, spec: ModelSpec, models_dir: Path, device=None):
        self.spec = spec
        self.cfg = spec.arch
        enc.check_supported(self.cfg)
        model_dir = models_dir / spec.short_name
        self.tokenizer = load_tokenizer(
            model_dir if model_dir.exists() else None, lowercase=self.cfg.lowercase,
            max_len=self.cfg.max_len, vocab_size=self.cfg.vocab_size)
        st = model_dir / "model.safetensors"
        if st.exists():
            params = enc.load_safetensors(st, self.cfg)
        else:
            params = enc.cached_init_params(self.cfg)
            log.warning("no local weights for %s; using the deterministic random init "
                        "of the JAX package (place model.safetensors under %s)",
                        spec.short_name, model_dir)
        self.encoder = enc.BertEncoder(self.cfg, params, device=resolve_device(device))
        # texts, real tokens and padded tokens sent through the encoder
        self.counts = {"texts": 0, "tokens": 0, "padded_tokens": 0}

    @staticmethod
    def _bucket(length: int) -> int:
        b = 16
        while b < length:
            b *= 2
        return min(b, 512)

    def featurize_queries(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Host tokenization for the fused read plane: query variant texts →
        ([Q, T] ids, [Q, T] mask) padded to a power-of-two token bucket. The
        device work (encode + top-k + BM25) happens in one call via
        VectorStore.{search,hybrid_search}_encoded."""
        encs = [self.tokenizer.encode(t) for t in texts]
        max_len = self._bucket(max((len(e.ids) for e in encs), default=1))
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for row, e in enumerate(encs):
            L = min(len(e.ids), max_len)
            ids[row, :L] = e.ids[:L]
            mask[row, :L] = 1
        return ids, mask

    def embed_async(self, texts: list[str], half_transfer: bool = False):
        """Tokenize and launch every bucket's batches now; the returned
        callable waits for the device and returns [N, dims] f32, rows in the
        order of ``texts``. ``half_transfer`` rounds to fp16 on the device
        before the copy, as the hash backend does."""
        if not texts:
            return lambda: np.zeros((0, self.spec.dims), np.float32)
        dev = self.encoder.device
        encs = [self.tokenizer.encode(t) for t in texts]
        order = sorted(range(len(encs)), key=lambda i: len(encs[i].ids))
        bs = _default_batch_size(self.spec.dims)
        pending: list[tuple[list[int], torch.Tensor]] = []
        for a in range(0, len(order), bs):
            batch_idx = order[a:a + bs]
            max_len = self._bucket(max(len(encs[i].ids) for i in batch_idx))
            ids = np.zeros((len(batch_idx), max_len), np.int32)
            mask = np.zeros((len(batch_idx), max_len), np.int32)
            for row, i in enumerate(batch_idx):
                n = min(len(encs[i].ids), max_len)
                ids[row, :n] = encs[i].ids[:n]
                mask[row, :n] = 1
            vecs = self.encoder.encode(torch.from_numpy(ids).to(dev),
                                       torch.from_numpy(mask).to(dev))
            pending.append((batch_idx, vecs.half() if half_transfer else vecs))
            self.counts["texts"] += len(batch_idx)
            self.counts["tokens"] += int(mask.sum())
            self.counts["padded_tokens"] += mask.size

        def finish() -> np.ndarray:
            out = np.zeros((len(texts), self.spec.dims), np.float32)
            for (batch_idx, _), host in zip(pending, to_host(*(v for _, v in pending))):
                out[batch_idx] = host.astype(np.float32)
            return out

        return finish

    def embed(self, texts: list[str]) -> np.ndarray:
        return self.embed_async(texts)()


class EmbeddingService:
    """Public embedding facade used by the index and search layers.
    ``db_path`` enables a fine-tuned hash table at ``<db>/hash_table.npz``."""

    def __init__(self, model: str | ModelSpec = DEFAULT_MODEL,
                 cache_dir: Path | None = None, use_persistent_cache: bool = True,
                 db_path: Path | None = None, device=None):
        spec = model if isinstance(model, ModelSpec) else parse_model(model)
        if spec is None:
            raise ValueError(f"unknown model: {model!r}")
        self.spec = spec
        table_path = None
        if spec.kind == "hash":
            if db_path is not None and (Path(db_path) / "hash_table.npz").exists():
                table_path = Path(db_path) / "hash_table.npz"
            self.backend = _HashBackend(spec, table_path=table_path, device=device)
        else:
            self.backend = _BertBackend(spec, get_global_models_cache_dir(), device=device)
        self.trained_table = table_path is not None
        self.mem_cache: LruBytesCache = default_memory_cache()
        self.persistent: PersistentEmbeddingCache | None = None
        if use_persistent_cache:
            # the port's vectors come from its own arithmetic: keep them in a
            # cache of their own, apart from the JAX package's
            cache_name = spec.short_name + "-torch"
            if self.trained_table:
                cache_name += "-t" + sha256_file(table_path)[:12]
            pdir = cache_dir or get_embedding_cache_dir(cache_name)
            self.persistent = PersistentEmbeddingCache(pdir, spec.dims)

    @property
    def dims(self) -> int:
        return self.spec.dims

    @property
    def model_name(self) -> str:
        return self.spec.short_name

    def fused_kind(self) -> str | None:
        """Which fused single-dispatch read plane this backend rides:
        "hash" (featurize → table gather), "bert" (tokenize → encoder
        forward), or None (no fused path — per-call embed only). ONE
        implementation consulted by the search pipeline and every serving
        surface, so routing cannot drift between them."""
        backend = self.backend
        hb = getattr(backend, "model", None)
        if hb is not None and hasattr(hb, "table"):
            return "hash"
        if hasattr(backend, "featurize_queries"):
            return "bert"
        return None

    # -- chunks ---------------------------------------------------------------

    def embed_chunks_matrix_async(self, chunks: list[Chunk]):
        """Async bulk-index fast path: cache lookups + host featurize +
        device dispatch happen NOW; the returned zero-arg callable blocks on
        the device result, writes the caches, and returns the [N, dims]
        matrix. The index pipeline keeps one slab in flight so slab N's
        encoder compute overlaps slab N-1's host store/FTS work (SURVEY §7
        "host/device pipeline overlap")."""
        if not chunks:
            return lambda: np.zeros((0, self.dims), np.float32)
        hashes = [c.hash for c in chunks]
        found: dict[str, np.ndarray] = {}
        for h in hashes:
            v = self.mem_cache.get(h)
            if v is not None:
                found[h] = v
        missing_after_mem = [h for h in set(hashes) if h not in found]
        if self.persistent is not None and missing_after_mem:
            disk = self.persistent.get_batch(missing_after_mem)
            for h, v in disk.items():
                found[h] = v
                self.mem_cache.put(h, v)
        to_compute: list[int] = []
        seen: set[str] = set()
        for i, c in enumerate(chunks):
            if c.hash not in found and c.hash not in seen:
                to_compute.append(i)
                seen.add(c.hash)
        finish_backend = None
        if to_compute:
            texts = [prepare_text(chunks[i]) for i in to_compute]
            # fp16 device→host: every row is quantized to fp16 at store
            # insert anyway; rounding before the copy halves the dominant
            # transfer of a bulk index. Cached values round identically, so
            # a later cache hit inserts the same fp16 row.
            finish_backend = self.backend.embed_async(texts,
                                                      half_transfer=True)

        def finish() -> np.ndarray:
            row_of: dict[str, int] = {}
            vecs = None
            if finish_backend is not None:
                vecs = np.asarray(finish_backend())
                new: dict[str, np.ndarray] = {}
                for row, i in enumerate(to_compute):
                    h = chunks[i].hash
                    row_of[h] = row
                    v = vecs[row]
                    new[h] = v
                    self.mem_cache.put(h, v)
                if self.persistent is not None:
                    self.persistent.put_batch(new)
            out = np.empty((len(chunks), self.dims), np.float32)
            fresh = [i for i, c in enumerate(chunks) if c.hash in row_of]
            if fresh:
                out[np.asarray(fresh)] = vecs[
                    np.asarray([row_of[chunks[i].hash] for i in fresh])
                ]
            for i, c in enumerate(chunks):
                if c.hash not in row_of:
                    out[i] = found[c.hash]
            return out

        return finish

    def embed_chunks_matrix(self, chunks: list[Chunk]) -> np.ndarray:
        """Bulk-index path: the [N, dims] matrix of ``chunks`` in order,
        through the memory and persistent caches. Freshly-computed rows land via a
        single vectorized gather from the backend's batch output instead
        of N per-row stacks (np.stack over 8k row views measured 1.7 s of
        a 15.7 s 65k-chunk index run on the one host core)."""
        return self.embed_chunks_matrix_async(chunks)()
