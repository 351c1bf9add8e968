"""Embedding model registry.

Mirrors the reference's 16-model fastembed registry
(embed/embedder.rs:7-197: names, dims, short names, parse aliases) and adds
the TPU-native additions:

- ``code-hash-384`` / ``code-hash-768``: deterministic, weights-free hashed
  random-projection embedders that run fully on device. These are the
  zero-download default (this environment has no model weights and no
  egress) and double as the trainable bootstrap model.
- each BERT-family entry carries its architecture config so the JAX encoder
  can be built/loaded from HF safetensors placed in the models cache dir.

Quantized ("-q") reference variants map to the same architecture with the
int8-corpus storage flag — on TPU, quantization lives in the vector store
(ops/topk.cosine_topk_int8), not in separate ONNX files.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ArchConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pooling: str = "mean"          # "mean" | "cls"
    lowercase: bool = True
    # architecture family (reference runs all three via ONNX graphs,
    # embed/embedder.rs:7-96; here each is a distinct JAX forward):
    #   "bert"       — learned positions, post-norm, GELU MLP
    #   "nomic"      — rotary positions, post-norm, SwiGLU, bias-free attn/MLP
    #   "modernbert" — rotary, PRE-norm, GeGLU, bias-free, alternating
    #                  local(sliding-window)/global attention
    arch_style: str = "bert"
    rope_base: float = 10000.0       # rotary base (global layers)
    rope_base_local: float = 10000.0  # rotary base for local layers (modernbert)
    local_window: int = 0            # sliding-window size (0 = all global)
    global_every: int = 1            # every Nth layer is global (modernbert: 3)
    # "absolute" (learned) | "alibi" (symmetric additive bias, JinaBERT-v2
    # style — no learned position table). Only meaningful for arch_style=bert.
    position_type: str = "absolute"


@dataclass(frozen=True)
class ModelSpec:
    short_name: str
    full_name: str
    dims: int
    kind: str                      # "bert" | "hash"
    arch: ArchConfig | None = None
    quantized: bool = False
    query_prefix: str = ""
    doc_prefix: str = ""
    aliases: tuple[str, ...] = ()


_BGE_QUERY_PREFIX = "Represent this sentence for searching relevant passages: "

_MINILM_L6 = ArchConfig(hidden=384, layers=6, heads=12, intermediate=1536)
_MINILM_L12 = ArchConfig(hidden=384, layers=12, heads=12, intermediate=1536)
_BGE_SMALL = ArchConfig(hidden=384, layers=12, heads=12, intermediate=1536, pooling="cls")
_BGE_BASE = ArchConfig(hidden=768, layers=12, heads=12, intermediate=3072, pooling="cls")
_BGE_LARGE = ArchConfig(hidden=1024, layers=24, heads=16, intermediate=4096, pooling="cls")
# nomic-bert-2048: rotary (base 1000), SwiGLU, bias-free attn/MLP, post-norm
# (nomic-ai/nomic-embed-text-v1 config.json)
_NOMIC = ArchConfig(vocab_size=30528, hidden=768, layers=12, heads=12,
                    intermediate=3072, max_len=2048,
                    arch_style="nomic", rope_base=1000.0)
_JINA_CODE = ArchConfig(vocab_size=61056, hidden=768, layers=12, heads=12, intermediate=3072, max_len=8192)
_E5_SMALL = ArchConfig(vocab_size=250037, hidden=384, layers=12, heads=12, intermediate=1536)
_MXBAI = ArchConfig(hidden=1024, layers=24, heads=16, intermediate=4096, pooling="cls")
# ModernBERT-large: pre-norm, GeGLU, bias-free, rotary with theta 160000 on
# global layers (every 3rd) / 10000 on local sliding-window-128 layers
# (answerdotai/ModernBERT-large config.json)
_MODERNBERT = ArchConfig(vocab_size=50368, hidden=1024, layers=28, heads=16,
                         intermediate=2624, max_len=8192, layer_norm_eps=1e-5,
                         arch_style="modernbert", rope_base=160000.0,
                         rope_base_local=10000.0, local_window=128,
                         global_every=3)


def _bert(short, full, dims, arch, *, q=False, qp="", dp="", aliases=()):
    return ModelSpec(
        short_name=short, full_name=full, dims=dims, kind="bert", arch=arch,
        quantized=q, query_prefix=qp, doc_prefix=dp, aliases=aliases,
    )


MODELS: dict[str, ModelSpec] = {}


def _register(spec: ModelSpec) -> None:
    MODELS[spec.short_name] = spec


for spec in [
    # --- TPU-native weights-free default ---
    ModelSpec("code-hash-384", "codesearch-tpu/code-hash-384", 384, "hash",
              aliases=("codehash", "hash")),
    ModelSpec("code-hash-768", "codesearch-tpu/code-hash-768", 768, "hash"),
    # --- MiniLM family ---
    _bert("minilm-l6", "sentence-transformers/all-MiniLM-L6-v2", 384, _MINILM_L6,
          aliases=("allminiml6v2",)),
    _bert("minilm-l6-q", "sentence-transformers/all-MiniLM-L6-v2 (quantized)", 384,
          _MINILM_L6, q=True, aliases=("allminiml6v2q",)),
    _bert("minilm-l12", "sentence-transformers/all-MiniLM-L12-v2", 384, _MINILM_L12,
          aliases=("allminiml12v2",)),
    _bert("minilm-l12-q", "sentence-transformers/all-MiniLM-L12-v2 (quantized)", 384,
          _MINILM_L12, q=True, aliases=("allminiml12v2q",)),
    _bert("paraphrase-minilm", "sentence-transformers/paraphrase-MiniLM-L6-v2", 384,
          _MINILM_L6),
    # --- BGE family ---
    _bert("bge-small", "BAAI/bge-small-en-v1.5", 384, _BGE_SMALL,
          qp=_BGE_QUERY_PREFIX, aliases=("bgesmallenv15",)),
    _bert("bge-small-q", "BAAI/bge-small-en-v1.5 (quantized)", 384, _BGE_SMALL,
          q=True, qp=_BGE_QUERY_PREFIX, aliases=("bgesmallenv15q",)),
    _bert("bge-base", "BAAI/bge-base-en-v1.5", 768, _BGE_BASE,
          qp=_BGE_QUERY_PREFIX, aliases=("bgebaseenv15",)),
    _bert("bge-large", "BAAI/bge-large-en-v1.5", 1024, _BGE_LARGE,
          qp=_BGE_QUERY_PREFIX, aliases=("bgelargeenv15",)),
    # --- Nomic family ---
    _bert("nomic-v1", "nomic-ai/nomic-embed-text-v1", 768, _NOMIC,
          qp="search_query: ", dp="search_document: ", aliases=("nomicembedtextv1",)),
    _bert("nomic-v1.5", "nomic-ai/nomic-embed-text-v1.5", 768, _NOMIC,
          qp="search_query: ", dp="search_document: ", aliases=("nomicembedtextv15",)),
    _bert("nomic-v1.5-q", "nomic-ai/nomic-embed-text-v1.5 (quantized)", 768, _NOMIC,
          q=True, qp="search_query: ", dp="search_document: ",
          aliases=("nomicembedtextv15q",)),
    # --- Specialized ---
    _bert("jina-code", "jinaai/jina-embeddings-v2-base-code", 768, _JINA_CODE,
          aliases=("jinaembeddingsv2basecode",)),
    _bert("e5-multilingual", "intfloat/multilingual-e5-small", 384, _E5_SMALL,
          qp="query: ", dp="passage: ", aliases=("multilinguale5small",)),
    _bert("mxbai-large", "mixedbread-ai/mxbai-embed-large-v1", 1024, _MXBAI,
          aliases=("mxbaiembedlargev1",)),
    _bert("modernbert-large", "lightonai/modernbert-embed-large", 1024, _MODERNBERT,
          qp="search_query: ", dp="search_document: ",
          aliases=("modernbertembedlarge",)),
]:
    _register(spec)

DEFAULT_MODEL = "code-hash-384"
# The reference defaults to bge-small; we keep that default when its weights
# are present in the models cache, else fall back to the weights-free model.
REFERENCE_DEFAULT_MODEL = "bge-small"


def parse_model(s: str) -> ModelSpec | None:
    low = s.strip().lower()
    if low in MODELS:
        return MODELS[low]
    for spec in MODELS.values():
        if low in spec.aliases or low == spec.full_name.lower():
            return spec
    return None


def all_models() -> list[ModelSpec]:
    return list(MODELS.values())
