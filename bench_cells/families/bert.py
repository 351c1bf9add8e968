"""BERT (``BertModel``; BAAI/bge-small-en-v1.5): word + learned position +
token-type 0 embeddings, LayerNorm; post-norm layers of biased Q, K, V
projections, softmax attention over the valid keys, output projection,
residual and LayerNorm, then an exact-GELU MLP, residual and LayerNorm; the
[CLS] state. Every layer attends over the whole text."""

from __future__ import annotations

import torch.nn.functional as F


def dims(cfg: dict) -> dict:
    c = cfg["config"]
    return {"family": "bert", "hidden": c["hidden_size"], "layers": c["num_hidden_layers"],
            "heads": c["num_attention_heads"], "intermediate": c["intermediate_size"],
            "vocab": c["vocab_size"], "positions": c["max_position_embeddings"],
            "eps": c["layer_norm_eps"], "rope_base": 0.0,
            "type_vocab": c["type_vocab_size"], "pooling": cfg["pooling"]}


def tensor_specs(dims: dict) -> list[tuple[str, tuple, str]]:
    h, i, v = dims["hidden"], dims["intermediate"], dims["vocab"]
    out = [("embeddings.word_embeddings.weight", (v, h), "dense"),
           ("embeddings.token_type_embeddings.weight", (dims["type_vocab"], h), "dense"),
           ("embeddings.position_embeddings.weight", (dims["positions"], h), "dense"),
           ("embeddings.LayerNorm.weight", (h,), "norm"),
           ("embeddings.LayerNorm.bias", (h,), "bias")]
    for n in range(dims["layers"]):
        p = f"encoder.layer.{n}."
        for part in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            out += [(p + part + ".weight", (h, h), "dense"), (p + part + ".bias", (h,), "bias")]
        out += [(p + "attention.output.LayerNorm.weight", (h,), "norm"),
                (p + "attention.output.LayerNorm.bias", (h,), "bias"),
                (p + "intermediate.dense.weight", (i, h), "dense"),
                (p + "intermediate.dense.bias", (i,), "bias"),
                (p + "output.dense.weight", (h, i), "dense"),
                (p + "output.dense.bias", (h,), "bias"),
                (p + "output.LayerNorm.weight", (h,), "norm"),
                (p + "output.LayerNorm.bias", (h,), "bias")]
    return out


def matmul_params(dims: dict) -> int:
    h, i = dims["hidden"], dims["intermediate"]
    return (4 * h * h + 2 * h * i) * dims["layers"]     # Q, K, V, output, MLP in and out


def layer_windows(dims: dict) -> list[int]:
    return [0] * dims["layers"]


def forward(enc, ids, mask):
    w, s = enc.w, ids.shape[1]
    x = w["embeddings.word_embeddings.weight"][ids]
    x = x + w["embeddings.token_type_embeddings.weight"][0]
    x = x + w["embeddings.position_embeddings.weight"][:s][None]
    x = enc._ln(x, "embeddings.LayerNorm")
    for i in range(enc.dims["layers"]):
        p = f"encoder.layer.{i}."
        q = enc._heads(enc._lin(x, p + "attention.self.query"))
        k = enc._heads(enc._lin(x, p + "attention.self.key"))
        v = enc._heads(enc._lin(x, p + "attention.self.value"))
        a = enc._lin(enc._merge(enc._attend(q, k, v, mask)), p + "attention.output.dense")
        x = enc._ln(x + a, p + "attention.output.LayerNorm")
        m = F.gelu(enc._lin(x, p + "intermediate.dense"))
        x = enc._ln(x + enc._lin(m, p + "output.dense"), p + "output.LayerNorm")
    return x[:, 0]


def served(dims: dict) -> dict:
    return {"arch_style": "bert"}
