"""ModernBERT (``ModernBertModel``; lightonai/modernbert-embed-large, the
answerdotai/ModernBERT-large backbone): word embeddings, a bias-free
LayerNorm; pre-norm layers (layer 0 takes its attention input without a
norm) of a bias-free fused QKV projection, the rotate-half rotary embedding
at ``global_rope_theta`` on every ``global_attn_every_n_layers``-th layer
(from layer 0) and at ``local_rope_theta`` on the others, attention over the
valid keys (the whole text on a global layer, the keys with |i - j| <=
``local_attention`` // 2 on a local one), a bias-free output projection and
the residual, then a bias-free LayerNorm, the GeGLU MLP ``Wo(gelu(a) * b)``
with ``a, b`` the two halves of ``Wi`` in that order, exact GELU, and the
residual; a final bias-free LayerNorm and the mean of the valid states.

Departures from the published model: none in the layers. The checkpoint
holds no MLM head (the embedding model has none); dropout is off, as at
inference; inputs come from the hashing tokenizer and stop at 512 tokens
(the configuration's ``assumed``); a padding row whose window holds no
valid key reads zeros (``Encoder._attend``), where HF's padded eager path
would give NaN or an average, and no valid state ever reads it."""

from __future__ import annotations

import torch.nn.functional as F


def dims(cfg: dict) -> dict:
    c = cfg["config"]
    return {"family": "modernbert", "hidden": c["hidden_size"],
            "layers": c["num_hidden_layers"], "heads": c["num_attention_heads"],
            "intermediate": c["intermediate_size"], "vocab": c["vocab_size"],
            "positions": c["max_position_embeddings"], "eps": c["norm_eps"],
            "rope_base": float(c["global_rope_theta"]),
            "rope_base_local": float(c["local_rope_theta"]),
            "local_window": c["local_attention"],
            "global_every": c["global_attn_every_n_layers"],
            "type_vocab": 0, "pooling": cfg["pooling"]}


def tensor_specs(dims: dict) -> list[tuple[str, tuple, str]]:
    h, i, v = dims["hidden"], dims["intermediate"], dims["vocab"]
    out = [("embeddings.tok_embeddings.weight", (v, h), "dense"),
           ("embeddings.norm.weight", (h,), "norm")]
    for n in range(dims["layers"]):
        p = f"layers.{n}."
        if n:
            out.append((p + "attn_norm.weight", (h,), "norm"))
        out += [(p + "attn.Wqkv.weight", (3 * h, h), "dense"),
                (p + "attn.Wo.weight", (h, h), "dense"),
                (p + "mlp_norm.weight", (h,), "norm"),
                (p + "mlp.Wi.weight", (2 * i, h), "dense"),
                (p + "mlp.Wo.weight", (h, i), "dense")]
    out.append(("final_norm.weight", (h,), "norm"))
    return out


def matmul_params(dims: dict) -> int:
    h, i = dims["hidden"], dims["intermediate"]
    # fused QKV, output, Wi (both halves), Wo
    return (3 * h * h + h * h + 2 * h * i + i * h) * dims["layers"]


def layer_windows(dims: dict) -> list[int]:
    return [0 if n % dims["global_every"] == 0 else dims["local_window"]
            for n in range(dims["layers"])]


def _norm(enc, x, name):
    """The bias-free LayerNorm (``Encoder._ln`` takes a bias)."""
    return F.layer_norm(x, (x.shape[-1],), enc.w[name + ".weight"], None, enc.dims["eps"])


def forward(enc, ids, mask):
    d, h = enc.dims, enc.dims["hidden"]
    x = _norm(enc, enc.w["embeddings.tok_embeddings.weight"][ids], "embeddings.norm")
    for n, window in enumerate(layer_windows(d)):
        p = f"layers.{n}."
        xa = _norm(enc, x, p + "attn_norm") if n else x
        qkv = enc._lin(xa, p + "attn.Wqkv", bias=False)
        q, k, v = (enc._heads(t) for t in qkv.split(h, dim=-1))
        base = d["rope_base_local"] if window else d["rope_base"]
        q, k = enc._rope(q, base), enc._rope(k, base)
        a = enc._attend(q, k, v, mask, window)
        x = x + enc._lin(enc._merge(a), p + "attn.Wo", bias=False)
        y, gate = enc._lin(_norm(enc, x, p + "mlp_norm"), p + "mlp.Wi", bias=False).chunk(2, dim=-1)
        x = x + enc._lin(F.gelu(y) * gate, p + "mlp.Wo", bias=False)
    x = _norm(enc, x, "final_norm")
    return (x * mask[:, :, None]).sum(1) / mask.sum(1, keepdim=True).clamp(min=1.0)


def served(dims: dict) -> dict:
    return {"arch_style": "modernbert", "rope_base": dims["rope_base"],
            "rope_base_local": dims["rope_base_local"], "local_window": dims["local_window"],
            "global_every": dims["global_every"]}
