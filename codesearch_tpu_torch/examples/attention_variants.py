"""Kernels d, e and f at 2, 4 and 8 warps per head, on the card.

The attention kernels of ``csrc/attention_kernels.cu`` give each head W
warps of 16 query rows (``kFullWarps`` for d, ``kPackedWarpsP2`` and
``kPackedWarpsP4`` for f, ``kFlashWarps`` for e). This script builds the
source once per W in {2, 4, 8} with ``-Xptxas -v`` and prints each kernel's
registers and spills and the CTAs per SM those registers, its threads and its
shared memory (S=512 for d and f) allow on an H100 (65,536 registers, 2,048
threads and 228 KB of shared memory an SM). Then it holds d, e and f (P=4,
P=2) of each variant against their plain twins and times them, the variants
in turns (W = 2, 4, 8, 8, 4, 2), beside ``scaled_dot_product_attention`` on
the same inputs (timed here only), at bge-small's heads (H=12, Dh=32):

- B=256, S=512 with ragged masks (lengths uniform in [1, S], row 0 full,
  the last row fully masked, as ``chip_smoke.py`` makes them);
- the same inputs with every row full;
- B=256, S=64 (the encoder's common bucket), ragged;
- d alone at S=32, B=256 (the synthetic corpus's other index bucket) and
  B=8 (a query's variants), ragged, and at Dh=64 (bge-base/large's heads),
  B=128, S=512, ragged;

d against e at the route's threshold and below it (B=16, S=1552 and
B=32, S=1024, ragged), and e alone at B=8, S=2048 on ragged and full masks,
at Dh=64 (B=16, S=1024, ragged) and at B=2, S=16,384 (one row full,
one fully masked). It prints a markdown table and the card's name and
power limit. With ``--source`` it compares the tree's source against other
versions of ``attention_kernels.cu`` (a parent commit's, an experiment)
instead of the warp counts, all in one call on one card.

Usage: python -m codesearch_tpu_torch.examples.attention_variants
       [--source other.cu ...] [--out table.md]
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import attention as att
from ..ops import packed_attention as pa
from .ablate_head_packing import card_line, cuda_ms

WARPS = (2, 4, 8)
SM_REGS, SM_THREADS, SM_SMEM = 65536, 2048, 233472
BUILD = _build.BUILD_DIR.parent / "attention_variants"
TOL = 1e-2   # atol and rtol against the plain twin: one bf16 step, as chip_smoke.py


def with_warps(src: str, warps: int) -> str:
    """The attention source with every warp constant set to ``warps``."""
    for name in ("kFullWarps", "kPackedWarpsP2", "kPackedWarpsP4", "kFlashWarps"):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {warps};", src)
        if n != 1:
            raise RuntimeError(f"{name} is not defined once in attention_kernels.cu")
    return src


def build_variant(i: int, src: str) -> subprocess.Popen:
    """Start nvcc on the top-k source and this attention source."""
    out = BUILD / str(i)
    out.mkdir(parents=True, exist_ok=True)
    (out / "attention_kernels.cu").write_text(src)
    return subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
         str(out / "kernels.so"), str(_build.CSRC_DIR / "topk_kernels.cu"),
         str(out / "attention_kernels.cu")],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def resources(ptxas: str) -> list[dict]:
    """Registers, spills and CTAs per SM of each two-sweep kernel (d, f) and
    each flash kernel (e)."""
    rows, cur = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"attention_two_sweepILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", m.group(1))
            e = re.search(r"attention_flashILi(\d+)ELi(\d+)EE", m.group(1))
            cur = None
            if t:
                dh, p, w, norm = (int(x) for x in t.groups())
                cur = {"kernel": "f" if norm else "d", "dh": dh, "P": p, "W": w}
            elif e:
                dh, w = (int(x) for x in e.groups())
                cur = {"kernel": "e", "dh": dh, "P": 1, "W": w}
            if cur is not None:
                rows.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spills"] = line.strip()
        elif cur is not None and "Used" in line and "registers" in line:
            cur["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    for r in rows:
        threads = r["P"] * r["W"] * 32
        # K and V rings, the bias (d, f: of S=512 keys; e: two tiles), 1 KB
        # reserved a CTA
        bias = 2 * 64 * 4 if r["kernel"] == "e" else 512 * 4
        smem = 4 * r["P"] * 64 * (r["dh"] + 8) * 2 + bias + 1024
        per_cta = -(-r["regs"] // 8) * 8 * threads
        r["ctas_per_sm"] = min(SM_REGS // per_cta, SM_THREADS // threads, SM_SMEM // smem, 32)
        r["warps_per_sm"] = r["ctas_per_sm"] * threads // 32
    return rows


def inputs(b: int, s: int, dh: int, seed: int, full: bool):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, 12, s, dh, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=torch.Generator().manual_seed(seed))
    lengths[0], lengths[-1] = s, 0
    if full:
        lengths[:] = s
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.float32).to("cuda")
    return q, k, v, mask


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, action="append", default=[],
                    help="another attention_kernels.cu to compare with the tree's")
    ap.add_argument("--out", type=Path, default=None, help="also write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA device", file=sys.stderr)
        return 1
    tree = (_build.CSRC_DIR / "attention_kernels.cu").read_text()
    if args.source:
        variants = {"tree": tree, **{str(p): p.read_text() for p in args.source}}
    else:
        variants = {f"W={w}": with_warps(tree, w) for w in WARPS}
    procs = {label: build_variant(i, src) for i, (label, src) in enumerate(variants.items())}
    libs, lines = {}, [f"card: {card_line()}", "",
                       "| variant | kernel | Dh | P | W | registers | spills | CTAs/SM | warps/SM |",
                       "|---|---|---|---|---|---|---|---|---|"]
    for i, (label, proc) in enumerate(procs.items()):
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
        libs[label] = _build.bind(BUILD / str(i) / "kernels.so")
        for r in resources(out):
            lines.append(f"| {label} | {r['kernel']} | {r['dh']} | {r['P']} | {r['W']} | "
                         f"{r['regs']} | {r['spills']} | {r['ctas_per_sm']} | "
                         f"{r['warps_per_sm']} |")
    labels = list(libs)
    lines += ["", "| kernel | shape | " + " | ".join(f"ms, {v}" for v in labels)
              + " | scaled_dot_product_attention ms | max abs err by variant |",
              "|---|---|" + "---|" * len(labels) + "---|---|"]
    kernels = {"d": (att.attention_full, att.attention_full_plain),
               "f P=4": (lambda *a: pa.attention_packed(*a, 4),
                         lambda *a: pa.attention_packed_plain(*a, 4)),
               "f P=2": (lambda *a: pa.attention_packed(*a, 2),
                         lambda *a: pa.attention_packed_plain(*a, 2)),
               "e": (att.attention_flash, att.attention_flash_plain)}
    cases = [("B=256 S=512 ragged", 256, 512, 32, False, ("d", "f P=4", "f P=2")),
             ("B=256 S=512 full", 256, 512, 32, True, ("d", "f P=4", "f P=2")),
             ("B=256 S=64 ragged", 256, 64, 32, False, ("d", "f P=4", "f P=2")),
             ("B=256 S=32 ragged", 256, 32, 32, False, ("d",)),
             ("B=8 S=32 ragged", 8, 32, 32, False, ("d",)),
             ("B=128 S=512 Dh=64 ragged", 128, 512, 64, False, ("d",)),
             ("B=32 S=1024 ragged", 32, 1024, 32, False, ("d", "e")),
             ("B=16 S=1552 ragged", 16, 1552, 32, False, ("d", "e")),
             ("B=8 S=2048 ragged", 8, 2048, 32, False, ("e",)),
             ("B=8 S=2048 full", 8, 2048, 32, True, ("e",)),
             ("B=16 S=1024 Dh=64 ragged", 16, 1024, 64, False, ("e",)),
             ("B=2 S=16384 ragged", 2, 16384, 32, False, ("e",))]
    ok = True
    for i, (shape, b, s, dh, full, names) in enumerate(cases):
        q, k, v, mask = inputs(b, s, dh, seed=i, full=full)
        bias = ((1.0 - mask) * -1e30)[:, None, None, :].to(q.dtype)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
                         reps=10)
        for name in names:
            kern, plain = kernels[name]
            ref = plain(q, k, v, mask).float()
            errs, times = {}, {var: [] for var in labels}
            for var in labels:
                _build._lib = libs[var]
                diff = (kern(q, k, v, mask).float() - ref).abs()
                errs[var] = float(diff.max())
                ok &= bool((diff <= TOL + TOL * ref.abs()).all())
            for var in (*labels, *reversed(labels)):
                _build._lib = libs[var]
                times[var].append(cuda_ms(lambda: kern(q, k, v, mask), reps=10))
            lines.append(f"| {name} | {shape} | "
                         + " | ".join(str(min(times[var])) for var in labels)
                         + f" | {lib_ms} | {', '.join(str(errs[var]) for var in labels)} |")
        del q, k, v, mask, bias
        torch.cuda.empty_cache()
    _build._lib = None
    table = "\n".join(lines) + "\n"
    print(table)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(table)
    if not ok:
        print("attention_variants: a kernel disagrees with its plain twin", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
