"""Head-packing ablation for Dh=32 encoder attention (the port of
``examples/ablate_head_packing.py``).

bge-small's attention runs 12 heads of Dh=32. The JAX study packs P heads
into one block-diagonal product to fill the TPU's 128-deep matrix unit; the
port's kernel f (``ops/packed_attention.py``) computes the same function with
one CTA owning the P heads of a head group. This script holds, on the same
inputs, the plain reference and kernel d (per head) against kernel f at
P=4 and P=2, and prints each one's max |delta| against the reference on valid
query rows and its time (CUDA events; on the CPU the time is not measured).
On the card a last line gives the study's verdict: f at P=4 against d.
It never calls a library attention.

Usage: python -m codesearch_tpu_torch.examples.ablate_head_packing
       [--batch 256] [--seq 512] [--heads 12] [--dh 32] [--device cuda|cpu]
       [--seed 0] [--out table.md]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.attention import attention_full, reference_attention
from ..ops.packed_attention import attention_packed
from ..utils.device import resolve_device


def make_inputs(b: int, h: int, s: int, d: int, seed: int, device):
    """Normal q, k, v in bf16 from a numpy seed and ragged key padding:
    lengths linspace(S/4, S, B), as the JAX study."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32))
               .to(torch.bfloat16).to(device) for _ in range(3))
    lens = np.linspace(s // 4, s, b).astype(np.int32)
    mask = torch.from_numpy((np.arange(s)[None, :] < lens[:, None]).astype(np.float32))
    return q, k, v, mask.to(device)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def ablate(b: int, h: int, s: int, d: int, device, seed: int = 0) -> list[dict]:
    """One row per variant: name, max |out - reference| over valid query
    rows, and its median time in ms (None off the card)."""
    q, k, v, mask = make_inputs(b, h, s, d, seed, device)
    ref = reference_attention(q, k, v, mask)
    valid = mask[:, None, :, None]
    rows = []
    for name, fn in (
            ("plain reference (reference_attention)",
             lambda: reference_attention(q, k, v, mask)),
            ("kernel d, per head (attention_full)", lambda: attention_full(q, k, v, mask)),
            ("kernel f, P=4 (attention_packed)", lambda: attention_packed(q, k, v, mask, 4)),
            ("kernel f, P=2 (attention_packed)", lambda: attention_packed(q, k, v, mask, 2))):
        out = fn()
        err = float(((out.float() - ref.float()) * valid).abs().max())
        ms = cuda_ms(fn) if q.is_cuda else None
        rows.append({"name": name, "max_abs_err": err, "ms": ms})
    return rows


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def render(rows: list[dict], b: int, h: int, s: int, d: int, where: str) -> str:
    lines = [
        "# Head-packing ablation (Dh=32 attention, PyTorch/CUDA port)",
        "",
        f"shape: B={b} H={h} S={s} Dh={d} bf16, ragged key padding; {where}",
        "",
        "| kernel | max abs err vs reference (valid query rows) | ms / call |",
        "|---|---|---|",
    ]
    for r in rows:
        ms = "not measured" if r["ms"] is None else f"{r['ms']:.4f}"
        lines.append(f"| {r['name']} | {r['max_abs_err']:.6f} | {ms} |")
    base, packed = rows[1]["ms"], rows[2]["ms"]
    if base is not None and packed is not None:
        win = "WIN — integrate" if packed < base * 0.95 else "no win — the per-head kernel stays"
        lines += ["", f"packed P=4 is {base / packed:.2f}x the current kernel ({win})."]
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--dh", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="also write the table here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b, h, s, d = args.batch, args.heads, args.seq, args.dh
    rows = ablate(b, h, s, d, device, args.seed)
    where = (f"card: {card_line()}" if device.type == "cuda"
             else "CPU run: times not measured")
    table = render(rows, b, h, s, d, where)
    print(table, end="")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
