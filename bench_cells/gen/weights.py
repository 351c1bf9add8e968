"""Seeded encoder weights, made on the device in one call and written as a
Hugging Face checkpoint (``model.safetensors``) for the program to load
through its normal path.

Every value is drawn in float32 from one ``torch.Generator`` on the device,
rounded to bfloat16 (the type the program serves them in) and stored as
float16, which holds those values exactly but for the few below 2^-17 in
magnitude. The reference reads the same float16 tensors."""

from __future__ import annotations

from pathlib import Path

import torch

DENSE_STD = 0.02
NORM_STD = 0.1


def tensor_specs(dims: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the checkpoint; kind is
    ``dense`` (N(0, 0.02)), ``norm`` (1 + N(0, 0.1)) or ``bias`` (N(0, 0.02))."""
    h, i, v = dims["hidden"], dims["intermediate"], dims["vocab"]
    out = [("embeddings.word_embeddings.weight", (v, h), "dense"),
           ("embeddings.token_type_embeddings.weight", (dims["type_vocab"], h), "dense")]
    if dims["family"] == "nomic":
        out += [("emb_ln.weight", (h,), "norm"), ("emb_ln.bias", (h,), "bias")]
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
    out += [("embeddings.position_embeddings.weight", (dims["positions"], h), "dense"),
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


def make_weights(dims: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors as float16 on ``device``."""
    specs = tensor_specs(dims)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        x = flat[at:at + n].view(shape)
        at += n
        x = 1.0 + NORM_STD * x if kind == "norm" else DENSE_STD * x
        out[name] = x.to(torch.bfloat16).to(torch.float16)
    return out


def write_checkpoint(weights: dict[str, torch.Tensor], path: Path) -> None:
    from safetensors.torch import save_file

    path.parent.mkdir(parents=True, exist_ok=True)
    save_file({k: v.detach().to("cpu").contiguous() for k, v in weights.items()}, str(path))
