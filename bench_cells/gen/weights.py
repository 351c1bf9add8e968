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

from ..families import family

DENSE_STD = 0.02
NORM_STD = 0.1


def tensor_specs(dims: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the checkpoint, in the order
    the weights are drawn (the family module's ``tensor_specs``); kind is
    ``dense`` (N(0, 0.02)), ``norm`` (1 + N(0, 0.1)) or ``bias`` (N(0, 0.02))."""
    return family(dims["family"]).tensor_specs(dims)


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
