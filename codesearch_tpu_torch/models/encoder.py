"""BERT-family text encoder on torch (port of ``codesearch_tpu/models/encoder.py``).

``BertEncoder`` runs ``arch_style="bert"`` models with learned absolute
positions (MiniLM, BGE, e5, mxbai, jina-code): embeddings, post-norm layers
with a fused QKV projection, exact GELU, CLS or masked-mean pooling and an L2
norm, as ``_encoder_layer``/``encode_hidden``/``encode`` of the JAX package.
Activations are bf16, LayerNorm runs in f32, the linear layers are
``torch.matmul`` (XLA ran them outside any kernel) and every layer's
attention is ``ops.attention.fused_encoder_attention``: kernels d and e on
CUDA. Rotary (Nomic, ModernBERT) and ALiBi models raise
``NotImplementedError``. The forward runs under ``torch.inference_mode()``.

Weights come as the JAX package's parameter tree of numpy arrays, from one
of three places:

- ``params_from_jax(tree)``: a tree from the JAX package, as numpy;
- ``init_params(cfg, seed)``: the JAX package's deterministic random init
  ``init_params(PRNGKey(seed), cfg)``, regenerated bit for bit in numpy
  (``jax_random``); ``cached_init_params`` keeps it under the config dir,
  since bge-small's ~33 M values take tens of seconds on one core;
- ``load_safetensors(path, cfg)``: a Hugging Face checkpoint.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_encoder_attention
from ..utils.constants import get_config_dir
from ..utils.device import resolve_device
from . import jax_random
from .registry import ArchConfig

_INIT_SCALE = np.float32(0.02)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the architectures this encoder does not run yet."""
    if cfg.arch_style != "bert" or cfg.position_type != "absolute":
        raise NotImplementedError(
            f"arch_style={cfg.arch_style!r}, position_type={cfg.position_type!r}: "
            "the port runs BERT encoders with absolute positions; rotary "
            "(Nomic, ModernBERT) and ALiBi models are not ported yet "
            "(ROADMAP.md Queue 1)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _dense_init(key, shape) -> np.ndarray:
    """``(jax.random.normal(key, shape) * 0.02).astype(float32)``."""
    return jax_random.normal(key, shape) * _INIT_SCALE


def init_layer_params(cfg: ArchConfig, layer: int, seed: int = 0) -> dict:
    """Layer ``layer`` of ``init_params(cfg, seed)``, alone."""
    check_supported(cfg)
    key = jax_random.split(jax_random.prng_key(seed), 6 + cfg.layers)[6 + layer]
    k = jax_random.split(key, 8)
    h, m = cfg.hidden, cfg.intermediate
    zeros = lambda n: np.zeros(n, np.float32)  # noqa: E731
    ones = lambda n: np.ones(n, np.float32)  # noqa: E731
    return {
        "q_w": _dense_init(k[0], (h, h)), "q_b": zeros(h),
        "k_w": _dense_init(k[1], (h, h)), "k_b": zeros(h),
        "v_w": _dense_init(k[2], (h, h)), "v_b": zeros(h),
        "o_w": _dense_init(k[3], (h, h)), "o_b": zeros(h),
        "attn_ln_scale": ones(h), "attn_ln_bias": zeros(h),
        "mlp_in_w": _dense_init(k[4], (h, m)), "mlp_in_b": zeros(m),
        "mlp_out_w": _dense_init(k[5], (m, h)), "mlp_out_b": zeros(h),
        "mlp_ln_scale": ones(h), "mlp_ln_bias": zeros(h),
    }


def init_params(cfg: ArchConfig, seed: int = 0) -> dict:
    """The JAX package's ``init_params(PRNGKey(seed), cfg)`` in numpy, equal
    bit for bit: ``split(key, 6 + layers)`` gives the word (0), position (1)
    and token-type (2) tables' keys and one key per layer (6 + i), each layer
    splitting its key in 8 for its dense weights; every weight is
    ``normal * 0.02`` in f32, biases zeros, LayerNorm scales ones."""
    check_supported(cfg)
    keys = jax_random.split(jax_random.prng_key(seed), 6 + cfg.layers)
    h = cfg.hidden
    return {
        "embeddings": {
            "word": _dense_init(keys[0], (cfg.vocab_size, h)),
            "token_type": _dense_init(keys[2], (cfg.type_vocab_size, h)),
            "ln_scale": np.ones(h, np.float32),
            "ln_bias": np.zeros(h, np.float32),
            "position": _dense_init(keys[1], (cfg.max_len, h)),
        },
        "layers": [init_layer_params(cfg, i, seed) for i in range(cfg.layers)],
    }


def flatten_params(tree: dict) -> dict[str, np.ndarray]:
    """{"embeddings.word": ..., "layers.3.q_w": ...} of a parameter tree."""
    flat = {f"embeddings.{k}": v for k, v in tree["embeddings"].items()}
    for i, layer in enumerate(tree["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return flat


def unflatten_params(flat) -> dict:
    tree: dict = {"embeddings": {}, "layers": []}
    for name in flat:
        parts = name.split(".")
        if parts[0] == "embeddings":
            tree["embeddings"][parts[1]] = flat[name]
        else:
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            tree["layers"][i][parts[2]] = flat[name]
    return tree


def init_cache_path(cfg: ArchConfig, seed: int = 0) -> Path:
    """Where ``cached_init_params`` keeps the init of this config and seed."""
    digest = hashlib.sha256(f"{cfg!r} seed={seed}".encode()).hexdigest()[:16]
    return get_config_dir() / f"bert_init_{digest}.torch.npz"


def save_params_npz(tree: dict, path: Path) -> None:
    """Atomic best-effort write of a parameter tree as one .npz file."""
    tmp = Path(f"{path}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flatten_params(tree))
        os.replace(tmp, path)
    except OSError:
        tmp.unlink(missing_ok=True)


def cached_init_params(cfg: ArchConfig, seed: int = 0) -> dict:
    """``init_params(cfg, seed)``, from the cache when it is there."""
    path = init_cache_path(cfg, seed)
    try:
        with np.load(path) as data:
            return unflatten_params({k: data[k] for k in data.files})
    except (OSError, ValueError, KeyError):
        pass
    tree = init_params(cfg, seed)
    save_params_npz(tree, path)
    return tree


def params_from_jax(tree: dict) -> dict:
    """A JAX package parameter tree (jax or numpy leaves) as f32 numpy
    (writable copies: torch takes them without copying again)."""
    return {
        "embeddings": {k: np.array(v, np.float32) for k, v in tree["embeddings"].items()},
        "layers": [{k: np.array(v, np.float32) for k, v in layer.items()}
                   for layer in tree["layers"]],
    }


# Hugging Face BERT checkpoint names (``codesearch_tpu/models/encoder.py``)
_HF_LAYER_MAP = {
    "q_w": "attention.self.query.weight", "q_b": "attention.self.query.bias",
    "k_w": "attention.self.key.weight", "k_b": "attention.self.key.bias",
    "v_w": "attention.self.value.weight", "v_b": "attention.self.value.bias",
    "o_w": "attention.output.dense.weight", "o_b": "attention.output.dense.bias",
    "attn_ln_scale": "attention.output.LayerNorm.weight",
    "attn_ln_bias": "attention.output.LayerNorm.bias",
    "mlp_in_w": "intermediate.dense.weight", "mlp_in_b": "intermediate.dense.bias",
    "mlp_out_w": "output.dense.weight", "mlp_out_b": "output.dense.bias",
    "mlp_ln_scale": "output.LayerNorm.weight", "mlp_ln_bias": "output.LayerNorm.bias",
}


def load_safetensors(path: Path, cfg: ArchConfig) -> dict:
    """A Hugging Face BERT checkpoint (``model.safetensors``) as the
    parameter tree; dense kernels are transposed (HF stores [out, in])."""
    from safetensors import safe_open

    check_supported(cfg)
    with safe_open(str(path), framework="np") as f:
        tensors = {key: f.get_tensor(key) for key in f.keys()}

    def get(name: str) -> np.ndarray:
        for prefix in ("", "bert.", "model.", "encoder."):
            if prefix + name in tensors:
                return np.array(tensors[prefix + name], np.float32)
        raise KeyError(f"missing tensor {name!r} (available: {len(tensors)})")

    tree: dict = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
            "position": get("embeddings.position_embeddings.weight"),
        },
        "layers": [],
    }
    for i in range(cfg.layers):
        layer = {}
        for ours, theirs in _HF_LAYER_MAP.items():
            t = get(f"encoder.layer.{i}.{theirs}")
            layer[ours] = np.ascontiguousarray(t.T) if ours.endswith("_w") else t
        tree["layers"].append(layer)
    return tree


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """f32 LayerNorm, result in the input's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps).to(x.dtype)


class _BertLayer(nn.Module):
    """One post-norm layer; dense weights and biases as bf16 (the JAX forward
    casts each to the activation dtype), LayerNorm parameters as f32."""

    def __init__(self, cfg: ArchConfig, p: dict, device):
        super().__init__()
        self.heads = cfg.heads
        self.eps = cfg.layer_norm_eps

        def buf(name, arr, dtype):
            t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
            self.register_buffer(name, t.to(device=device, dtype=dtype))

        # fused QKV: one [h, 3h] product instead of three [h, h]
        buf("qkv_w", np.concatenate([p["q_w"], p["k_w"], p["v_w"]], axis=1), torch.bfloat16)
        buf("qkv_b", np.concatenate([p["q_b"], p["k_b"], p["v_b"]]), torch.bfloat16)
        for name in ("o_w", "o_b", "mlp_in_w", "mlp_in_b", "mlp_out_w", "mlp_out_b"):
            buf(name, p[name], torch.bfloat16)
        for name in ("attn_ln_scale", "attn_ln_bias", "mlp_ln_scale", "mlp_ln_bias"):
            buf(name, p[name], torch.float32)

    def forward(self, x: torch.Tensor, maskf: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        qkv = torch.matmul(x, self.qkv_w) + self.qkv_b
        # [B, H, S, Dh] strided views of the projection: no copies
        q, k, v = (t.view(b, s, self.heads, h // self.heads).transpose(1, 2)
                   for t in qkv.split(h, dim=-1))
        attn = fused_encoder_attention(q, k, v, maskf)
        attn = attn.transpose(1, 2).reshape(b, s, h)
        attn = torch.matmul(attn, self.o_w) + self.o_b
        x = _layer_norm(x + attn, self.attn_ln_scale, self.attn_ln_bias, self.eps)
        mlp = F.gelu(torch.matmul(x, self.mlp_in_w) + self.mlp_in_b)
        mlp = torch.matmul(mlp, self.mlp_out_w) + self.mlp_out_b
        return _layer_norm(x + mlp, self.mlp_ln_scale, self.mlp_ln_bias, self.eps)


class BertEncoder(nn.Module):
    """A BERT encoder on ``device`` from a parameter tree (see the module
    docstring for the three sources)."""

    def __init__(self, cfg: ArchConfig, params: dict, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        emb = params["embeddings"]
        for name in ("word", "token_type", "position", "ln_scale", "ln_bias"):
            t = torch.from_numpy(np.ascontiguousarray(emb[name], np.float32))
            self.register_buffer(f"emb_{name}", t.to(self.device))
        self.layers = nn.ModuleList(
            _BertLayer(cfg, p, self.device) for p in params["layers"])

    @torch.inference_mode()
    def encode_hidden(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        """[B, S] ids + mask -> [B, S, hidden] bf16 states."""
        s = input_ids.shape[1]
        tt = self.emb_token_type[0] if token_type_ids is None \
            else self.emb_token_type[token_type_ids.long()]
        x = self.emb_word[input_ids.long()] + tt
        x = x + self.emb_position[:s][None]
        x = _layer_norm(x, self.emb_ln_scale, self.emb_ln_bias, self.cfg.layer_norm_eps)
        x = x.to(torch.bfloat16)
        maskf = attention_mask.float()
        for layer in self.layers:
            x = layer(x, maskf)
        return x

    @torch.inference_mode()
    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, S] ids + mask -> [B, hidden] L2-normalized f32 embeddings."""
        x32 = self.encode_hidden(input_ids, attention_mask).float()
        if self.cfg.pooling == "cls":
            pooled = x32[:, 0, :]
        else:
            maskf = attention_mask.float()
            denom = torch.clamp(maskf.sum(dim=1, keepdim=True), min=1.0)
            pooled = (x32 * maskf[:, :, None]).sum(dim=1) / denom
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)

    forward = encode
