"""BERT-family text encoders on torch (port of ``codesearch_tpu/models/encoder.py``).

``BertEncoder`` runs the three architecture families of the registry, as
``_encoder_layer``/``_nomic_layer``/``_modernbert_layer``,
``encode_hidden`` and ``encode`` of the JAX package do:

- ``arch_style="bert"``: embeddings, post-norm layers with a fused QKV
  projection and exact GELU; learned absolute positions (MiniLM, BGE, e5,
  mxbai, jina-code), or none and an ALiBi bias in every layer's attention
  (``position_type="alibi"``, the jina-reranker form);
- ``arch_style="nomic"``: rotary positions, a bias-free fused QKV, post-norm,
  SwiGLU ``fc11(x) * silu(fc12(x))``;
- ``arch_style="modernbert"``: pre-norm with bias-free norms (layer 0 has
  no attention norm), rotary with a global and a local base, GeGLU, every
  ``global_every``-th layer global and the others a sliding window of
  ``local_window`` keys, a final norm.

Activations are bf16, norms run in f32, rotary angles in f32 with ``cos``
and ``sin`` rounded to bf16, the linear layers are ``torch.matmul`` (XLA ran
them outside any kernel) and every layer's attention is
``ops.attention.fused_encoder_attention``: kernels d and e on CUDA, the
windowed kernel for ModernBERT's local layers outside autograd, the
composed ``reference_attention`` for ALiBi layers and for windowed ones
under autograd (JAX composes both in XLA). CLS or masked-mean pooling, then
an L2 norm.

Two forms share the layers. The inference form (the default) holds the
dense weights as bf16 buffers and runs under ``torch.inference_mode()``.
The trainable form (``trainable=True``) holds every weight as an f32
``nn.Parameter`` (the master weights), casts the dense ones to bf16 inside
each forward as the JAX forward does, keeps the norms f32 and runs with
grad: the attention then takes ``fused_encoder_attention``'s autograd route
(kernel d or e forward, ``reference_attention`` recomputed backward).
``to_params()`` gives the JAX package's parameter tree back, with a BERT
layer's fused QKV split into ``q_w``/``k_w``/``v_w`` again.

The sharded form (``mesh=``, a ``parallel.train_mesh.TrainMesh``; trainable
only) holds this rank's shards under the JAX package's ``_rule_for`` and
runs the same layers with the collectives GSPMD would insert:

- BERT: each rank holds the q, k and v columns of its own heads (H /
  n_model, fused locally as ``[h, 3h / n_model]``) and its columns of
  ``mlp_in``; the attention runs on those heads (kernel d or e as on one
  device); ``copy_to_model`` before the column-parallel products,
  ``row_parallel`` (the partial products summed in f32) for ``o_w`` and
  ``mlp_out_w`` (this rank's rows), ``o_b`` and ``mlp_out_b`` added once
  after the sum. An ALiBi model takes its heads' rows of the bias;
- ModernBERT: only ``o_w`` is split (its fused ``qkv_w`` and ``wi_w`` are
  replicated, their names not being in the rule): the replicated attention
  output, sliced to this rank's rows of ``o_w``, then ``row_parallel``;
- Nomic: no layer weight is split;
- every family: the word table split by vocabulary rows (ids clamped to
  the global table first, then ``vocab_parallel_lookup``).

``encode`` replays an inference forward on CUDA as a CUDA graph when it
can (``graph_key``): at most ``GRAPH_MAX_ROWS`` rows, not trainable, no
mesh. The graph is the eager forward captured as it runs (kernel d's
launches included), one per (rows rounded up to a power of two, S); a
shape runs eagerly the first time it is seen, is captured the second time
and replayed from the third, so a shape that never repeats costs nothing.
Every other forward runs eagerly.

``gather_params()`` returns the full JAX-layout tree on rank 0;
``gather_tensors``/``shard_tensors`` move any per-parameter tensors
(parameters, gradients, Adam moments) between a rank's shards and the
one-device layout.

Weights come as the JAX package's parameter tree (numpy arrays, or tensors
in a checkpoint's dtype), from one of three places:

- ``params_from_jax(tree)``: a tree from the JAX package, as numpy;
- ``init_params(cfg, seed)``: the JAX package's deterministic random init
  ``init_params(PRNGKey(seed), cfg)``, regenerated bit for bit in numpy
  (``jax_random``); ``cached_init_params`` keeps it under the config dir,
  since bge-small's ~33 M values (nomic-v1.5's 137 M) take tens of seconds;
- ``load_safetensors(path, cfg, device)``: a Hugging Face checkpoint, its
  data section read once onto ``device`` as raw bytes (through a ring of
  pinned buffers on CUDA) and viewed there as tensors; the encoder's one
  copy of each transposes and casts it on the device.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention
from ..ops.attention import alibi_bias, fused_encoder_attention
from ..parallel import train_mesh as tm
from ..utils.constants import get_config_dir
from ..utils.device import resolve_device
from ..utils.tracing import count, span
from . import jax_random
from .registry import ArchConfig

_INIT_SCALE = np.float32(0.02)


ARCH_STYLES = ("bert", "nomic", "modernbert")
POSITION_TYPES = ("absolute", "alibi")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for an architecture no family of the JAX package describes."""
    if cfg.arch_style not in ARCH_STYLES or cfg.position_type not in POSITION_TYPES:
        raise ValueError(f"arch_style={cfg.arch_style!r}, position_type="
                         f"{cfg.position_type!r}: the encoder runs {ARCH_STYLES} with "
                         f"{POSITION_TYPES} positions")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

# keys ``init_params`` splits off the root before the layers' own
_TOP_KEYS = {"bert": 6, "nomic": 3, "modernbert": 2}


def _dense_init(key, shape) -> np.ndarray:
    """``(jax.random.normal(key, shape) * 0.02).astype(float32)``."""
    return jax_random.normal(key, shape) * _INIT_SCALE


def _root_keys(cfg: ArchConfig, seed: int) -> list:
    return jax_random.split(jax_random.prng_key(seed), _TOP_KEYS[cfg.arch_style] + cfg.layers)


def init_layer_params(cfg: ArchConfig, layer: int, seed: int = 0) -> dict:
    """Layer ``layer`` of ``init_params(cfg, seed)``, alone: its key splits
    in 8 (BERT), 5 (Nomic) or 4 (ModernBERT) for its dense weights."""
    check_supported(cfg)
    key = _root_keys(cfg, seed)[_TOP_KEYS[cfg.arch_style] + layer]
    h, m = cfg.hidden, cfg.intermediate
    zeros = lambda n: np.zeros(n, np.float32)  # noqa: E731
    ones = lambda n: np.ones(n, np.float32)  # noqa: E731
    if cfg.arch_style == "nomic":
        k = jax_random.split(key, 5)
        return {
            "qkv_w": _dense_init(k[0], (h, 3 * h)), "out_w": _dense_init(k[1], (h, h)),
            "norm1_scale": ones(h), "norm1_bias": zeros(h),
            "fc11_w": _dense_init(k[2], (h, m)), "fc12_w": _dense_init(k[3], (h, m)),
            "fc2_w": _dense_init(k[4], (m, h)),
            "norm2_scale": ones(h), "norm2_bias": zeros(h),
        }
    if cfg.arch_style == "modernbert":
        k = jax_random.split(key, 4)
        out = {
            "qkv_w": _dense_init(k[0], (h, 3 * h)), "o_w": _dense_init(k[1], (h, h)),
            "wi_w": _dense_init(k[2], (h, 2 * m)), "wo_w": _dense_init(k[3], (m, h)),
            "mlp_ln_scale": ones(h),
        }
        if layer > 0:
            out["attn_ln_scale"] = ones(h)
        return out
    k = jax_random.split(key, 8)
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
    bit for bit. The root key splits in 6 (BERT: word 0, position 1,
    token-type 2), 3 (Nomic: word 0, token-type 1) or 2 (ModernBERT: word
    0) plus one key per layer; every weight is ``normal * 0.02`` in f32,
    biases zeros, norm scales ones. An ALiBi BERT has no position table,
    ModernBERT no token types, no norm biases and a top-level
    ``final_ln_scale``."""
    check_supported(cfg)
    keys = _root_keys(cfg, seed)
    h = cfg.hidden
    emb = {"word": _dense_init(keys[0], (cfg.vocab_size, h)),
           "ln_scale": np.ones(h, np.float32)}
    tree: dict = {"embeddings": emb}
    if cfg.arch_style == "modernbert":
        tree["final_ln_scale"] = np.ones(h, np.float32)
    else:
        tt_key = keys[1] if cfg.arch_style == "nomic" else keys[2]
        emb["token_type"] = _dense_init(tt_key, (cfg.type_vocab_size, h))
        emb["ln_bias"] = np.zeros(h, np.float32)
        if cfg.arch_style == "bert" and cfg.position_type != "alibi":
            emb["position"] = _dense_init(keys[1], (cfg.max_len, h))
    tree["layers"] = [init_layer_params(cfg, i, seed) for i in range(cfg.layers)]
    return tree


def flatten_params(tree: dict) -> dict[str, np.ndarray]:
    """{"embeddings.word": ..., "final_ln_scale": ..., "layers.3.q_w": ...}
    of a parameter tree (layers may hold different names)."""
    flat = {f"embeddings.{k}": v for k, v in tree["embeddings"].items()}
    flat.update({k: v for k, v in tree.items() if k not in ("embeddings", "layers")})
    for i, layer in enumerate(tree["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return flat


def unflatten_params(flat) -> dict:
    tree: dict = {"embeddings": {}, "layers": []}
    for name in flat:
        parts = name.split(".")
        if parts[0] == "embeddings":
            tree["embeddings"][parts[1]] = flat[name]
        elif parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            tree["layers"][i][parts[2]] = flat[name]
        else:
            tree[name] = flat[name]
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
    return unflatten_params({k: np.array(v, np.float32)
                             for k, v in flatten_params(tree).items()})


# Hugging Face checkpoint names (``codesearch_tpu/models/encoder.py``)
HF_LAYER_MAP = {
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
# nomic-bert-2048 (nomic-ai/nomic-embed-text-v1): encoder.layers.{i}.*
_NOMIC_LAYER_MAP = {
    "qkv_w": "attn.Wqkv.weight", "out_w": "attn.out_proj.weight",
    "norm1_scale": "norm1.weight", "norm1_bias": "norm1.bias",
    "fc11_w": "mlp.fc11.weight", "fc12_w": "mlp.fc12.weight", "fc2_w": "mlp.fc2.weight",
    "norm2_scale": "norm2.weight", "norm2_bias": "norm2.bias",
}
# ModernBERT (answerdotai/ModernBERT-large): layers.{i}.*, no attn_norm on layer 0
_MODERNBERT_LAYER_MAP = {
    "qkv_w": "attn.Wqkv.weight", "o_w": "attn.Wo.weight",
    "wi_w": "mlp.Wi.weight", "wo_w": "mlp.Wo.weight",
    "mlp_ln_scale": "mlp_norm.weight", "attn_ln_scale": "attn_norm.weight",
}


# safetensors header dtypes -> the torch dtype their bytes are viewed as
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
STAGE_BYTES = 32 << 20       # a read's step: one pinned buffer of the CUDA reader
STAGE_SLOTS = 3              # pinned buffers in the ring
# the CUDA reader's ring, pinned on first use and kept for the process
# (pinning costs more than the copy it serves); the lock lends it to one read
_RING: list[torch.Tensor] = []
_RING_LOCK = threading.Lock()


def _read_into(f, view: memoryview) -> None:
    """Fill ``view`` from the unbuffered file ``f`` (a read may return less)."""
    while view.nbytes:
        n = f.readinto(view)
        if not n:
            raise ValueError(f"{f.name}: the file ends inside its data section")
        view = view[n:]


def _fill(f, blob: torch.Tensor) -> None:
    """Read the next ``blob.numel()`` bytes of ``f`` into ``blob``: on the
    CPU straight into it; on CUDA in steps of ``STAGE_BYTES``, each into a
    pinned buffer of the ring, then copied to the card while the next step
    reads into the next buffer (an event per buffer guards its reuse)."""
    if blob.device.type != "cuda":
        _read_into(f, memoryview(blob.numpy()))
        return
    stream = torch.cuda.current_stream(blob.device)
    with _RING_LOCK:
        if not _RING:
            _RING.extend(torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
                         for _ in range(STAGE_SLOTS))
        done: list = [None] * len(_RING)
        try:
            for step, at in enumerate(range(0, blob.numel(), STAGE_BYTES)):
                slot = step % len(_RING)
                if done[slot] is not None:
                    done[slot].synchronize()
                k = min(STAGE_BYTES, blob.numel() - at)
                _read_into(f, memoryview(_RING[slot].numpy())[:k])
                blob[at:at + k].copy_(_RING[slot][:k], non_blocking=True)
                done[slot] = stream.record_event()
        finally:
            # the ring goes back, and a failed read's blob is freed, only
            # once the copies queued have read and written them
            stream.synchronize()


def read_safetensors(path: Path, device=None) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file on ``device`` (``resolve_device``),
    in the file's dtype: views of one uint8 tensor that holds the file's
    data section, read once (``_fill``). A tensor whose offset is not a
    multiple of its element size is a copy of its bytes. The span
    ``cs.model.load`` counts the section's ``bytes`` and the ``tensors``."""
    device = resolve_device(device)
    with span("cs.model.load") as sp, open(path, "rb", buffering=0) as f:
        head = bytearray(8)
        _read_into(f, memoryview(head))
        header_len = int.from_bytes(head, "little")
        n = os.fstat(f.fileno()).st_size - 8 - header_len
        if n < 0:
            raise ValueError(f"{path}: a header of {header_len} bytes does not fit the file")
        header = bytearray(header_len)
        _read_into(f, memoryview(header))
        entries = json.loads(header)
        entries.pop("__metadata__", None)
        blob = torch.empty(n, dtype=torch.uint8, device=device)
        _fill(f, blob)
        tensors = {}
        for name, e in entries.items():
            dtype = SAFETENSORS_DTYPES.get(e["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype {e['dtype']}; the reader "
                                 f"takes {sorted(SAFETENSORS_DTYPES)}")
            a, b = e["data_offsets"]
            if not 0 <= a <= b <= n:
                raise ValueError(f"{path}: tensor {name!r} lies outside the data section")
            raw = blob[a:b]
            if a % dtype.itemsize:
                raw = raw.clone()
            tensors[name] = raw.view(dtype).view(e["shape"])
        if sp:
            sp.add(bytes=n, tensors=len(tensors))
    return tensors


def checkpoint_params(tensors: dict[str, torch.Tensor], cfg: ArchConfig) -> dict:
    """The parameter tree of the config's family from a checkpoint's
    tensors (``read_safetensors``), each found under its Hugging Face name
    or that name after a ``bert.``/``model.``/``encoder.`` prefix (else
    ``KeyError``). The leaves keep the file's dtype and device; a dense
    kernel (``*_w``; HF stores [out, in]) is its transposed view, laid out
    and cast when ``BertEncoder`` registers it."""
    check_supported(cfg)

    def get(name: str) -> torch.Tensor:
        for prefix in ("", "bert.", "model.", "encoder."):
            if prefix + name in tensors:
                return tensors[prefix + name]
        raise KeyError(f"missing tensor {name!r} (available: {len(tensors)})")

    def layer(prefix: str, names: dict, skip=()) -> dict:
        out = {}
        for ours, theirs in names.items():
            if ours in skip:
                continue
            t = get(prefix + theirs)
            out[ours] = t.t() if ours.endswith("_w") else t
        return out

    if cfg.arch_style == "nomic":
        emb = {"word": get("embeddings.word_embeddings.weight"),
               "token_type": get("embeddings.token_type_embeddings.weight"),
               "ln_scale": get("emb_ln.weight"), "ln_bias": get("emb_ln.bias")}
        layers = [layer(f"encoder.layers.{i}.", _NOMIC_LAYER_MAP) for i in range(cfg.layers)]
        return {"embeddings": emb, "layers": layers}
    if cfg.arch_style == "modernbert":
        emb = {"word": get("embeddings.tok_embeddings.weight"),
               "ln_scale": get("embeddings.norm.weight")}
        layers = [layer(f"layers.{i}.", _MODERNBERT_LAYER_MAP,
                        skip=() if i else ("attn_ln_scale",)) for i in range(cfg.layers)]
        return {"embeddings": emb, "final_ln_scale": get("final_norm.weight"),
                "layers": layers}
    emb = {"word": get("embeddings.word_embeddings.weight"),
           "token_type": get("embeddings.token_type_embeddings.weight"),
           "ln_scale": get("embeddings.LayerNorm.weight"),
           "ln_bias": get("embeddings.LayerNorm.bias")}
    if cfg.position_type != "alibi":
        emb["position"] = get("embeddings.position_embeddings.weight")
    layers = [layer(f"encoder.layer.{i}.", HF_LAYER_MAP) for i in range(cfg.layers)]
    return {"embeddings": emb, "layers": layers}


def load_safetensors(path: Path, cfg: ArchConfig, device=None) -> dict:
    """A Hugging Face checkpoint (``model.safetensors``) of the config's
    family as the parameter tree on ``device`` (``checkpoint_params`` of
    ``read_safetensors``). The tree holds the file's bytes on the device
    until it is dropped: drop it once the encoder is built."""
    return checkpoint_params(read_safetensors(path, device), cfg)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """f32 LayerNorm (``bias`` None: bias-free), result in the input's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps).to(x.dtype)


def _rope_tables(s: int, dh: int, base: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [S, 1, Dh] of the rotate-half rotary embedding at
    ``base``: f32 angles (bf16 phase error compounds over long sequences),
    rounded to bf16 as JAX casts them to the activation dtype, kept as f32."""
    inv = 1.0 / (base ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))
    freqs = torch.outer(torch.arange(s, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    return (emb.cos().to(torch.bfloat16).float(), emb.sin().to(torch.bfloat16).float())


def _apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """``x * cos + rotate_half(x) * sin`` over [B, S, n, Dh] bf16 (here q
    and k together, n = 2H), the f32 products summed and rounded once."""
    cos, sin = rope
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


def _is_dense(name: str) -> bool:
    return name.endswith(("_w", "_b"))


def _register(module: nn.Module, name: str, arr, device, trainable: bool,
              dtype=torch.float32) -> None:
    """``arr`` (a numpy array, or a tensor such as a checkpoint's transposed
    view) as an f32 parameter (``trainable``) or a buffer of ``dtype``: a
    new contiguous tensor on ``device`` that shares no memory with ``arr``,
    filled by one copy that lays it out and casts it. f16 and bf16 values
    are f32 values, so each value rounds at most once, to ``dtype``, as an
    f32 leaf does (an f64 one rounds to f32 first)."""
    src = arr if isinstance(arr, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
    if src.dtype == torch.float64:
        src = src.float()
    t = torch.empty(src.shape, dtype=torch.float32 if trainable else dtype, device=device)
    t.copy_(src)
    if trainable:
        module.register_parameter(name, nn.Parameter(t))
    else:
        module.register_buffer(name, t)


class _Layer(nn.Module):
    """Dense weights (``*_w``, ``*_b``) as bf16 buffers (the JAX forward casts
    each to the activation dtype), norm parameters as f32; trainable, every
    weight an f32 parameter and the dense ones cast in ``weights()``."""

    def __init__(self, cfg: ArchConfig, p: dict, device, trainable: bool = False, mesh=None):
        super().__init__()
        self.heads = cfg.heads
        self.eps = cfg.layer_norm_eps
        self.trainable = trainable
        self.mesh = mesh
        for name, arr in p.items():
            _register(self, name, arr, device, trainable,
                      torch.bfloat16 if _is_dense(name) else torch.float32)

    def weights(self) -> dict:
        """The forward's weights by name: the buffers as they are, or the f32
        parameters with the dense ones cast to bf16."""
        if not self.trainable:
            return self._buffers
        return {name: p.to(torch.bfloat16) if _is_dense(name) else p
                for name, p in self._parameters.items()}

    def _heads(self, qkv: torch.Tensor, rope=None):
        """q, k, v [B, H, S, Dh] of a fused [B, S, 3h] projection: strided
        views, or with ``rope`` q and k rotated into one new [B, S, 2H, Dh]
        tensor (v stays a view)."""
        b, s, h3 = qkv.shape
        dh = h3 // (3 * self.heads)
        parts = qkv.view(b, s, 3 * self.heads, dh)
        if rope is None:
            q, k, v = parts.split(self.heads, dim=2)
        else:
            qk = _apply_rope(parts[:, :, :2 * self.heads], rope)
            (q, k), v = qk.split(self.heads, dim=2), parts[:, :, 2 * self.heads:]
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _to_model(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated input that this rank uses in part (a column-parallel
        product, a slice): on a mesh, its gradient summed over "model"."""
        return x if self.mesh is None else tm.copy_to_model(x, self.mesh)

    def _row_product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w``, or on a mesh this rank's rows of ``w`` against its
        columns of ``x``, summed over "model"."""
        return torch.matmul(x, w) if self.mesh is None else tm.row_parallel(x, w, self.mesh)


class _BertLayer(_Layer):
    """One post-norm BERT layer (``_encoder_layer``): fused biased QKV,
    GELU MLP; ``bias2d`` is the ALiBi bias of an ALiBi model."""

    def __init__(self, cfg: ArchConfig, p: dict, device, trainable: bool = False, mesh=None):
        cat = lambda *ts: torch.cat([torch.as_tensor(t) for t in ts], dim=-1)  # noqa: E731
        fused = {"qkv_w": cat(p["q_w"], p["k_w"], p["v_w"]),
                 "qkv_b": cat(p["q_b"], p["k_b"], p["v_b"])}
        rest = {k: v for k, v in p.items() if k[:2] not in ("q_", "k_", "v_")}
        super().__init__(cfg, {**fused, **rest}, device, trainable, mesh)
        if mesh is not None:        # this rank's heads
            self.heads = cfg.heads // mesh.n_model

    def forward(self, x: torch.Tensor, maskf: torch.Tensor, bias2d=None) -> torch.Tensor:
        b, s, _ = x.shape
        w = self.weights()
        q, k, v = self._heads(torch.matmul(self._to_model(x), w["qkv_w"]) + w["qkv_b"])
        attn = fused_encoder_attention(q, k, v, maskf, bias2d=bias2d)
        attn = attn.transpose(1, 2).reshape(b, s, -1)
        attn = self._row_product(attn, w["o_w"]) + w["o_b"]
        x = _layer_norm(x + attn, w["attn_ln_scale"], w["attn_ln_bias"], self.eps)
        mlp = F.gelu(torch.matmul(self._to_model(x), w["mlp_in_w"]) + w["mlp_in_b"])
        mlp = self._row_product(mlp, w["mlp_out_w"]) + w["mlp_out_b"]
        return _layer_norm(x + mlp, w["mlp_ln_scale"], w["mlp_ln_bias"], self.eps)


class _NomicLayer(_Layer):
    """One nomic-bert layer (``_nomic_layer``): bias-free fused QKV, rotary,
    post-norm, SwiGLU ``fc11(x) * silu(fc12(x))``."""

    def forward(self, x: torch.Tensor, maskf: torch.Tensor, rope) -> torch.Tensor:
        b, s, h = x.shape
        w = self.weights()
        q, k, v = self._heads(torch.matmul(x, w["qkv_w"]), rope)
        attn = fused_encoder_attention(q, k, v, maskf)
        attn = torch.matmul(attn.transpose(1, 2).reshape(b, s, h), w["out_w"])
        x = _layer_norm(x + attn, w["norm1_scale"], w["norm1_bias"], self.eps)
        y = torch.matmul(x, w["fc11_w"])
        gate = torch.matmul(x, w["fc12_w"])
        mlp = torch.matmul(y * F.silu(gate), w["fc2_w"])
        return _layer_norm(x + mlp, w["norm2_scale"], w["norm2_bias"], self.eps)


class _ModernBertLayer(_Layer):
    """One ModernBERT layer (``_modernbert_layer``): pre-norm (none before
    layer 0's attention), bias-free, rotary, windowed attention on local
    layers, GeGLU ``gelu(inp) * gate`` of ``Wi``'s halves in that order."""

    def __init__(self, cfg: ArchConfig, p: dict, device, index: int, trainable: bool = False,
                 mesh=None):
        super().__init__(cfg, p, device, trainable, mesh)
        self.is_global = index % cfg.global_every == 0
        self.window = 0 if self.is_global else cfg.local_window
        self.first = index == 0

    def forward(self, x: torch.Tensor, maskf: torch.Tensor, rope) -> torch.Tensor:
        b, s, h = x.shape
        w = self.weights()
        xa = x if self.first else _layer_norm(x, w["attn_ln_scale"], None, self.eps)
        q, k, v = self._heads(torch.matmul(xa, w["qkv_w"]), rope)
        attn = fused_encoder_attention(q, k, v, maskf, window=self.window)
        attn = attn.transpose(1, 2).reshape(b, s, h)
        if self.mesh is not None:   # the replicated output's rows of this rank's o_w
            attn = tm.take_shard(self._to_model(attn), 2, self.mesh)
        x = x + self._row_product(attn, w["o_w"])
        xm = _layer_norm(x, w["mlp_ln_scale"], None, self.eps)
        inp, gate = torch.matmul(xm, w["wi_w"]).chunk(2, dim=-1)
        return x + torch.matmul(F.gelu(inp) * gate, w["wo_w"])


def _module_shard_dims(cfg: ArchConfig, specs: dict) -> dict[str, tuple[int, int]]:
    """(dimension, blocks) of every module parameter split over "model",
    from the JAX-layout partitions: a BERT layer's fused ``qkv_w``/``qkv_b``
    takes its q, k and v parts' dimension in 3 blocks."""
    out = {}
    for name, spec in flatten_params(specs).items():
        dim = tm.split_dim(spec)
        if dim is None:
            continue
        parts = name.split(".")
        blocks = 1
        if cfg.arch_style == "bert" and parts[-1][:2] in ("q_", "k_", "v_"):
            parts[-1], blocks = "qkv_" + parts[-1][2:], 3
        name = ".".join(parts)
        if name.startswith("embeddings."):
            name = "emb_" + name[len("embeddings."):]
        out[name] = (dim, blocks)
    return out


# ---------------------------------------------------------------------------
# CUDA graphs of the inference forward
# ---------------------------------------------------------------------------

GRAPH_MAX_ROWS = 64          # the read plane's largest wave (``DynamicBatcher.max_wave``)


def graph_key(rows: int, seq: int, device_type: str, trainable: bool,
              mesh) -> tuple[int, int] | None:
    """The CUDA graph that replays an encoder forward of ``rows`` x ``seq``
    ids on ``device_type``: (``rows`` rounded up to a power of two,
    ``seq``). None for a forward that runs eagerly: not on CUDA, trainable,
    on a mesh, or more than ``GRAPH_MAX_ROWS`` rows."""
    if device_type != "cuda" or trainable or mesh is not None \
            or not 0 < rows <= GRAPH_MAX_ROWS:
        return None
    return 1 << (rows - 1).bit_length(), seq


def _launch_counters() -> tuple:
    """``ops.attention``'s counters: a replay adds what its capture counted."""
    return attention.launch_counts, attention.launches_by_seq, attention.composed_counts


def _add_counts(counts: list[dict], sign: int = 1) -> None:
    """Adds ``counts`` (one dict a counter of ``_launch_counters``) times
    ``sign``, and to the program counters that follow the windowed routes."""
    for counter, added in zip(_launch_counters(), counts):
        for k, n in added.items():
            counter[k] += sign * n
            if k in attention.WINDOW_COUNTERS:
                count(attention.WINDOW_COUNTERS[k], sign * n)


class _ForwardGraphs:
    """One encoder's inference forwards as CUDA graphs, one a ``graph_key``.
    A key's first forward runs eagerly; its second runs the forward once on
    a side stream (the warm-up, whose result it returns) and captures it;
    every later one copies its ids and mask into the graph's static inputs
    (padding rows: ids 0, mask 0) and replays the graph. The result is a new
    tensor each time: a clone of the static output's real rows, so no later
    replay overwrites what an earlier call returned. The encoder's graphs
    share one memory pool. ``lock`` covers the copy-in, the replay and the
    clone, since callers on several threads may share one encoder.

    The eager forward comes with each call: held here, it would make the
    encoder a reference cycle, which only the garbage collector frees,
    weights and graphs included."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seen: set = set()
        # key -> (graph, static ids, static mask, static output, launch counts)
        self.graphs: dict = {}
        self.pool = None
        self.side = None

    def __call__(self, forward, key, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        n = ids.shape[0]
        with self.lock, torch.cuda.device(ids.device):
            entry = self.graphs.get(key)
            if entry is None:
                if key not in self.seen:
                    self.seen.add(key)
                    count("encoder.eager_forwards")
                    return forward(ids, mask)
                return self._capture(forward, key, ids, mask)
            graph, s_ids, s_mask, s_out, counts = entry
            s_ids[:n].copy_(ids)
            s_mask[:n].copy_(mask)
            if n < key[0]:
                s_ids[n:].zero_()
                s_mask[n:].zero_()
            graph.replay()
            _add_counts(counts)
            count("encoder.graph_replays")
            return s_out[:n].clone()

    def _capture(self, forward, key, ids, mask) -> torch.Tensor:
        rows, seq = key
        n = ids.shape[0]
        s_ids = ids.new_zeros(rows, seq)
        s_mask = mask.new_zeros(rows, seq)
        s_ids[:n] = ids
        s_mask[:n] = mask
        if self.side is None:
            self.side = torch.cuda.Stream()
            self.pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        # the capture is ``torch.cuda.graph``'s without its device-wide
        # synchronize and ``empty_cache``, so the cached blocks stay for the
        # eager batches that follow (an index call's); other threads (the
        # servers') may use the device meanwhile
        with torch.cuda.stream(self.side):
            out = forward(s_ids, s_mask)
            before = [dict(c) for c in _launch_counters()]
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                s_out = forward(s_ids, s_mask)
            finally:
                graph.capture_end()
        main.wait_stream(self.side)
        out.record_stream(main)
        # the capture ran nothing on the device: its counts go to the replays
        counts = [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
                  for c, b in zip(_launch_counters(), before)]
        _add_counts(counts, -1)
        self.graphs[key] = (graph, s_ids, s_mask, s_out, counts)
        count("encoder.graph_captures")
        return out[:n]


class BertEncoder(nn.Module):
    """An encoder of any registry family on ``device`` from a parameter tree
    (see the module docstring for the families, the two forms and the three
    sources)."""

    def __init__(self, cfg: ArchConfig, params: dict, device=None, trainable: bool = False,
                 mesh: tm.TrainMesh | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.trainable = trainable
        self.vocab_rows = params["embeddings"]["word"].shape[0]
        # (dimension, blocks) of each parameter split over "model"
        self.shard_dims: dict[str, tuple[int, int]] = {}
        if mesh is not None:
            if not trainable:
                raise ValueError("a sharded encoder is trainable (trainable=True)")
            if cfg.arch_style == "bert" and cfg.heads % mesh.n_model:
                raise ValueError(f"q_w: {cfg.heads} heads do not divide by the 'model' axis "
                                 f"({mesh.n_model})")
            self.shard_dims = _module_shard_dims(cfg, tm.param_shardings(params, mesh))
            params = tm.shard_params(params, mesh)
        for name, arr in params["embeddings"].items():
            _register(self, f"emb_{name}", arr, self.device, trainable)
        if cfg.arch_style == "modernbert":
            _register(self, "final_ln_scale", params["final_ln_scale"], self.device, trainable)
            layers = (_ModernBertLayer(cfg, p, self.device, i, trainable, mesh)
                      for i, p in enumerate(params["layers"]))
        elif cfg.arch_style == "nomic":
            layers = (_NomicLayer(cfg, p, self.device, trainable, mesh)
                      for p in params["layers"])
        else:
            layers = (_BertLayer(cfg, p, self.device, trainable, mesh) for p in params["layers"])
        self.layers = nn.ModuleList(layers)
        self._graphs = _ForwardGraphs()

    def _grad_mode(self):
        """Grad for the trainable form, ``torch.inference_mode()`` otherwise."""
        return contextlib.nullcontext() if self.trainable else torch.inference_mode()

    def to_params(self) -> dict:
        """The JAX package's parameter tree of f32 numpy arrays (a BERT
        layer's fused QKV split into ``q_*``, ``k_*``, ``v_*`` again); on a
        mesh, this rank's shards."""
        return self._jax_tree(dict((*self.named_buffers(), *self.named_parameters())))

    def _jax_tree(self, tensors: dict) -> dict:
        flat = {}
        for name, t in tensors.items():
            arr = t.detach().float().cpu().numpy()
            name = name.replace("emb_", "embeddings.", 1) if name.startswith("emb_") else name
            if self.cfg.arch_style == "bert" and name.endswith(("qkv_w", "qkv_b")):
                for part, block in zip("qkv", np.split(arr, 3, axis=-1)):
                    flat[name.replace("qkv", part)] = np.ascontiguousarray(block)
            else:
                flat[name] = arr
        return unflatten_params(flat)

    def gather_tensors(self, tensors: dict) -> dict | None:
        """Per-parameter tensors by parameter name (the parameters, their
        gradients, Adam moments), this rank's shards -> the one-device
        layout in f32: a collective over "model" on a mesh, the result on
        rank 0 and None on the others; without a mesh, detached."""
        if self.mesh is None:
            return {name: t.detach() for name, t in tensors.items()}
        full = {}
        for name, t in tensors.items():
            dim, blocks = self.shard_dims.get(name, (None, 1))
            full[name] = tm.gather_shard(t, dim, self.mesh, blocks)
        return full if self.mesh.rank == 0 else None

    def shard_tensors(self, tensors: dict) -> dict:
        """One-device-layout tensors by parameter name -> this rank's
        shards (as they are without a mesh)."""
        if self.mesh is None:
            return dict(tensors)
        out = {}
        for name, t in tensors.items():
            dim, blocks = self.shard_dims.get(name, (None, 1))
            out[name] = tm.take_shard(t, dim, self.mesh, blocks)
        return out

    def gather_params(self, grads: bool = False) -> dict | None:
        """The full JAX-layout parameter tree (f32 numpy; ``grads``: the
        parameters' gradients) on rank 0, None on the other ranks; a
        collective over "model". Without a mesh, the tree of this model."""
        named = {name: p.grad if grads else p for name, p in self.named_parameters()}
        full = self.gather_tensors(named)
        return None if full is None else self._jax_tree(full)

    def encode_hidden(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        """[B, S] ids + mask -> [B, S, hidden] bf16 states."""
        with self._grad_mode():
            return self._hidden(input_ids, attention_mask, token_type_ids)

    def _hidden(self, input_ids, attention_mask, token_type_ids):
        cfg = self.cfg
        s = input_ids.shape[1]
        maskf = attention_mask.float()
        # ids past the table take its last row, as XLA's gather clamps them
        ids = input_ids.long().clamp(max=self.vocab_rows - 1)
        x = self.emb_word[ids] if self.mesh is None \
            else tm.vocab_parallel_lookup(self.emb_word, ids, self.mesh)
        if cfg.arch_style == "modernbert":
            x = _layer_norm(x, self.emb_ln_scale, None, cfg.layer_norm_eps).to(torch.bfloat16)
            dh = cfg.hidden // cfg.heads
            ropes = {base: _rope_tables(s, dh, base, self.device)
                     for base in {cfg.rope_base, cfg.rope_base_local}}
            for layer in self.layers:
                x = layer(x, maskf, ropes[cfg.rope_base if layer.is_global
                                         else cfg.rope_base_local])
            return _layer_norm(x, self.final_ln_scale, None, cfg.layer_norm_eps)
        tt = self.emb_token_type[0] if token_type_ids is None \
            else self.emb_token_type[token_type_ids.long()]
        x = x + tt
        bias2d = None
        if cfg.arch_style == "bert" and cfg.position_type == "alibi":
            # one [H, S, S] bias a forward, shared by every layer (on a mesh,
            # this rank's heads)
            bias2d = alibi_bias(cfg.heads, s, device=self.device)
            if self.mesh is not None:
                bias2d = tm.take_shard(bias2d, 0, self.mesh)
        elif cfg.arch_style == "bert":
            x = x + self.emb_position[:s][None]
        x = _layer_norm(x, self.emb_ln_scale, self.emb_ln_bias, cfg.layer_norm_eps)
        x = x.to(torch.bfloat16)
        if cfg.arch_style == "nomic":
            rope = _rope_tables(s, cfg.hidden // cfg.heads, cfg.rope_base, self.device)
            for layer in self.layers:
                x = layer(x, maskf, rope)
            return x
        for layer in self.layers:
            x = layer(x, maskf, bias2d)
        return x

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, S] ids + mask -> [B, hidden] L2-normalized f32 embeddings, a
        new tensor. A forward that ``graph_key`` admits replays a CUDA graph
        from the third time its key is seen (``_ForwardGraphs``)."""
        with self._grad_mode():
            key = graph_key(*input_ids.shape, input_ids.device.type, self.trainable, self.mesh)
            if key is not None:
                return self._graphs(self._pooled, key, input_ids, attention_mask)
            if input_ids.is_cuda and not self.trainable:
                count("encoder.eager_forwards")
            return self._pooled(input_ids, attention_mask)

    def _pooled(self, input_ids, attention_mask):
        x32 = self._hidden(input_ids, attention_mask, None).float()
        if self.cfg.pooling == "cls":
            pooled = x32[:, 0, :]
        else:
            maskf = attention_mask.float()
            denom = torch.clamp(maskf.sum(dim=1, keepdim=True), min=1.0)
            pooled = (x32 * maskf[:, :, None]).sum(dim=1) / denom
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)

    forward = encode
