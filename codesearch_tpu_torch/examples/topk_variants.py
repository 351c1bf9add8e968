"""Kernels a, b and c under variants of ``csrc/topk_kernels.cu``, on the card.

Builds the top-k source once per variant, each with the tree's attention
source so that the library binds as the port's does: the tree's own, the
tree's with ``constexpr`` values changed (``--set kStages=4``, or several in
one variant: ``--set kChunk=384,kStages=4``), or another version of the
file (``--source``, which must keep the tree's C interface). It prints the
score pass's registers and spills (ptxas) and CTAs per SM (the occupancy
API) of each. Then it holds a, b and c of each variant against their plain
twins (b and c bit for bit, a within 1e-5) and times them in turns (the
variants in order, then reversed) at the main path's shapes, N=262,144
rows, d=384, ~5% invalid rows and every 7th row a copy of its neighbour: a
and b at Q=1 and Q=9 query variants, k=200; c at B=1 and B=8 score rows,
k=256, a third of each row exactly 0.0. A time is the device microseconds a
call, summed over the call's kernels from the profiler (no host launch
cost), the smaller of the two turns. With no option it compares the tree
with ``kStages=4``.

Usage: python -m codesearch_tpu_torch.examples.topk_variants
       [--set NAME=VALUE[,NAME=VALUE...] ...] [--source other.cu ...] [--out table.md]
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import fused_topk as ft
from ..ops.bm25 import DEAD_SLOT
from .ablate_head_packing import card_line

BUILD = _build.BUILD_DIR.parent / "topk_variants"
N_ROWS, DIMS = 262_144, 384
TOL = 1e-5   # a against its plain twin: f32 sums over d in another order


def with_constants(src: str, sets: str) -> str:
    """The top-k source with each ``NAME=VALUE`` of ``sets`` (comma-separated)
    as its ``constexpr int NAME``."""
    for item in sets.split(","):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise RuntimeError(f"{name} is not defined once in topk_kernels.cu")
    return src


def score_pass_resources(ptxas: str) -> dict:
    """{"a" / "b": registers and spill lines} of the score pass, from ptxas -v."""
    out, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"cosine_scoresILb([01])E", m.group(1))
            cur = ("b" if t.group(1) == "1" else "a") if t else None
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in line:
            out[cur]["spills"] = line.strip()
        elif cur and "Used" in line and "registers" in line:
            out[cur]["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def kernel_split(fn, calls: int = 10) -> dict:
    """Device microseconds a call of ``fn`` by kernel (``torch.profiler`` over
    ``calls`` calls), names shortened to their template."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", ""):
            e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def build_variant(i: int, src: str) -> subprocess.Popen:
    """Start nvcc on this top-k source and the tree's attention source."""
    out = BUILD / str(i)
    out.mkdir(parents=True, exist_ok=True)
    (out / "topk_kernels.cu").write_text(src)
    return subprocess.Popen(
        [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
         str(out / "kernels.so"), str(out / "topk_kernels.cu"),
         str(_build.CSRC_DIR / "attention_kernels.cu")],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def inputs():
    """The corpus (bf16 and int8 with scales), its validity, nine queries,
    eight score rows with their slot kinds and boost kinds, on the card."""
    gen = torch.Generator().manual_seed(0)
    c = torch.randn(N_ROWS, DIMS, generator=gen)
    c = c / c.norm(dim=1, keepdim=True)
    c[1::7] = c[0::7][: c[1::7].shape[0]]
    valid = torch.rand(N_ROWS, generator=gen) > 0.05
    q9 = c[:9] + 0.02 * torch.randn(9, DIMS, generator=gen)
    cq, scale = ft.quantize_rows_int8(c)
    meta = torch.randint(0, 6, (N_ROWS,), generator=gen, dtype=torch.int32)
    meta[torch.rand(N_ROWS, generator=gen) < 0.05] = DEAD_SLOT
    s8 = torch.rand(8, N_ROWS, generator=gen)
    s8[:, ::3] = 0.0
    kid = torch.arange(8, dtype=torch.int32) % 7 - 1
    return [t.cuda() for t in (c.to(torch.bfloat16), cq, scale, valid, q9, meta, s8, kid)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help="NAME=VALUE[,NAME=VALUE...]: one variant of the tree's source")
    ap.add_argument("--source", type=Path, action="append", default=[],
                    help="another topk_kernels.cu to compare with the tree's")
    ap.add_argument("--out", type=Path, default=None, help="also write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_variants: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # a's plain twin in full f32
    tree = (_build.CSRC_DIR / "topk_kernels.cu").read_text()
    variants = {"tree": tree}
    for sets in args.sets or ([] if args.source else ["kStages=4"]):
        variants[sets] = with_constants(tree, sets)
    variants.update({str(p): p.read_text() for p in args.source})
    procs = {label: build_variant(i, src) for i, (label, src) in enumerate(variants.items())}
    libs, lines = {}, [f"card: {card_line()}", "",
                       "| variant | score pass | registers | spills | CTAs/SM at d=384 |",
                       "|---|---|---|---|---|"]
    for i, (label, proc) in enumerate(procs.items()):
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
        libs[label] = lib = _build.bind(BUILD / str(i) / "kernels.so")
        for kind, r in score_pass_resources(out).items():
            lines.append(f"| {label} | {kind} | {r['regs']} | {r['spills']} | "
                         f"{lib.cs_cosine_ctas_per_sm(int(kind == 'b'), DIMS)} |")
    cb, cq, scale, valid, q9, meta, s8, kid = inputs()
    calls = {}
    for q in (q9[:1], q9):
        calls[f"a Q={q.shape[0]} k=200"] = (
            lambda q=q: ft.fused_cosine_topk(q, cb, valid, 200),
            lambda q=q: ft.fused_cosine_topk_plain(q, cb, valid, 200), False)
        calls[f"b Q={q.shape[0]} k=200"] = (
            lambda q=q: ft.fused_cosine_topk_int8(q, cq, scale, valid, 200),
            lambda q=q: ft.fused_cosine_topk_int8_plain(q, cq, scale, valid, 200), True)
    for b in (1, 8):
        calls[f"c B={b} k=256"] = (
            lambda b=b: ft.fused_scores_topk(s8[:b], meta, kid[:b], 256, DEAD_SLOT),
            lambda b=b: ft.fused_scores_topk_plain(s8[:b], meta, kid[:b], 256, DEAD_SLOT), True)
    labels = list(libs)
    lines += ["", "| call | " + " | ".join(f"device us, {v}" for v in labels)
              + " | by kernel (first variant) |", "|---|" + "---|" * len(labels) + "---|"]
    ok = True
    for name, (kern, plain, exact) in calls.items():
        ref = plain()
        times, split = {v: [] for v in labels}, None
        for var in labels:
            _build._lib = libs[var]
            got = kern()
            if exact:
                ok &= torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            else:
                ok &= float((got[0] - ref[0]).abs().max()) <= TOL
        for var in (*labels, *reversed(labels)):
            _build._lib = libs[var]
            by_kernel = kernel_split(kern)
            split = split or by_kernel
            times[var].append(sum(by_kernel.values()))
        lines.append(f"| {name} | " + " | ".join(f"{min(times[v]):.2f}" for v in labels)
                     + " | " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " |")
    _build._lib = None
    table = "\n".join(lines) + "\n"
    print(table)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(table)
    if not ok:
        print("topk_variants: a kernel disagrees with its plain twin", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
