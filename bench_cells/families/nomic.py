"""NomicBERT (``NomicBertModel``; nomic-ai/nomic-embed-text-v1.5): word +
token-type 0 embeddings, LayerNorm; post-norm layers of a bias-free fused QKV
projection, rotary position embedding (rotate-half, base
``rotary_emb_base``, over the whole head), attention over the valid keys,
bias-free output projection, residual and LayerNorm, then the SwiGLU MLP
``fc2(fc11(x) * silu(fc12(x)))``, residual and LayerNorm; the mean of the
valid states. Every layer attends over the whole text."""

from __future__ import annotations

import torch.nn.functional as F


def dims(cfg: dict) -> dict:
    c = cfg["config"]
    return {"family": "nomic", "hidden": c["n_embd"], "layers": c["n_layer"],
            "heads": c["n_head"], "intermediate": c["n_inner"],
            "vocab": c["vocab_size"], "positions": c["n_positions"],
            "eps": c["layer_norm_epsilon"], "rope_base": float(c["rotary_emb_base"]),
            "type_vocab": c["type_vocab_size"], "pooling": cfg["pooling"]}


def tensor_specs(dims: dict) -> list[tuple[str, tuple, str]]:
    h, i, v = dims["hidden"], dims["intermediate"], dims["vocab"]
    out = [("embeddings.word_embeddings.weight", (v, h), "dense"),
           ("embeddings.token_type_embeddings.weight", (dims["type_vocab"], h), "dense"),
           ("emb_ln.weight", (h,), "norm"), ("emb_ln.bias", (h,), "bias")]
    for n in range(dims["layers"]):
        p = f"encoder.layers.{n}."
        out += [(p + "attn.Wqkv.weight", (3 * h, h), "dense"),
                (p + "attn.out_proj.weight", (h, h), "dense"),
                (p + "norm1.weight", (h,), "norm"), (p + "norm1.bias", (h,), "bias"),
                (p + "mlp.fc11.weight", (i, h), "dense"),
                (p + "mlp.fc12.weight", (i, h), "dense"),
                (p + "mlp.fc2.weight", (h, i), "dense"),
                (p + "norm2.weight", (h,), "norm"), (p + "norm2.bias", (h,), "bias")]
    return out


def matmul_params(dims: dict) -> int:
    h, i = dims["hidden"], dims["intermediate"]
    # fused QKV, output, fc11 + fc12, fc2
    return (3 * h * h + h * h + 2 * h * i + i * h) * dims["layers"]


def layer_windows(dims: dict) -> list[int]:
    return [0] * dims["layers"]


def forward(enc, ids, mask):
    w, h = enc.w, enc.dims["hidden"]
    x = w["embeddings.word_embeddings.weight"][ids]
    x = x + w["embeddings.token_type_embeddings.weight"][0]
    x = enc._ln(x, "emb_ln")
    base = enc.dims["rope_base"]
    for i in range(enc.dims["layers"]):
        p = f"encoder.layers.{i}."
        qkv = enc._lin(x, p + "attn.Wqkv", bias=False)
        q, k, v = (enc._heads(t) for t in qkv.split(h, dim=-1))
        q, k = enc._rope(q, base), enc._rope(k, base)
        a = enc._lin(enc._merge(enc._attend(q, k, v, mask)), p + "attn.out_proj", bias=False)
        x = enc._ln(x + a, p + "norm1")
        y = enc._lin(x, p + "mlp.fc11", bias=False)
        gate = enc._lin(x, p + "mlp.fc12", bias=False)
        x = enc._ln(x + enc._lin(y * F.silu(gate), p + "mlp.fc2", bias=False), p + "norm2")
    return (x * mask[:, :, None]).sum(1) / mask.sum(1, keepdim=True).clamp(min=1.0)


def served(dims: dict) -> dict:
    return {"arch_style": "nomic", "rope_base": dims["rope_base"]}
