"""A search corpus of ``chunks`` chunks: the texts of seeded functions, cut
into pieces as an indexer cuts long definitions, and clustered unit
vectors drawn on the device, one centre a file, so that neighbours and
near-ties occur as they do in a real index."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np

from .code import CodeWriter, corpus_shape, permuted


@dataclass
class Chunks:
    content: list[str]
    path: list[str]
    signature: list[str]
    kind: list[str]
    language: list[str]
    start: list[int]
    end: list[int]
    group: np.ndarray            # file index of each chunk
    names: list[str]             # every definition's name
    writer: CodeWriter
    primary_language: str

    def __len__(self) -> int:
        return len(self.content)


def split_lines(n: int, max_lines: int, overlap: int) -> list[tuple[int, int]]:
    """[a, b) line ranges covering ``n`` lines, at most ``max_lines`` each,
    consecutive ranges sharing ``overlap`` lines."""
    if n <= max_lines:
        return [(0, n)]
    out, a = [], 0
    while True:
        b = min(n, a + max_lines)
        out.append((a, b))
        if b == n:
            return out
        a = b - overlap


_COLUMNS = ("content", "path", "signature", "kind", "language", "start", "end")


def _part(args) -> dict:
    """The chunk columns of one writer's share of the files."""
    p, seed, part = args
    parts = int(p["writers"])
    lines, per_file, langs = permuted(corpus_shape(p, int(p["functions"])),
                                      np.random.default_rng(seed))
    lo, hi = part * len(per_file) // parts, (part + 1) * len(per_file) // parts
    first_fn = int(per_file[:lo].sum())
    writer = CodeWriter(seed, p, stream=part)
    files = writer.write(lines[first_fn:], per_file[lo:hi], langs[lo:hi], p["path_prefix"], lo)
    cols = {k: [] for k in _COLUMNS}
    group, names, lang_files = [], [], {}
    for fi, f in enumerate(files, lo):
        lang_files[f.language] = lang_files.get(f.language, 0) + 1
        line = len(f.header)
        for u in f.units:
            names.append(u.name)
            for a, b in split_lines(len(u.lines), p["chunk_max_lines"], p["chunk_overlap"]):
                cols["content"].append("\n".join(u.lines[a:b]))
                cols["path"].append(f.path)
                cols["signature"].append(u.signature)
                cols["kind"].append(u.kind)
                cols["language"].append(f.language)
                cols["start"].append(line + a)
                cols["end"].append(line + b)
                group.append(fi)
            line += len(u.lines) + 1
    return {"cols": cols, "group": group, "names": names, "langs": lang_files}


def make_chunks(p: dict, seed: int, n_chunks: int, workers: int = 1) -> Chunks:
    """The first ``n_chunks`` chunks of the corpus, its files written by
    ``p["writers"]`` writers (the text depends on that count, not on
    ``workers``, the processes that run them)."""
    jobs = [(p, seed, part) for part in range(int(p["writers"]))]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(jobs)), mp_context=ctx) as pool:
            parts = list(pool.map(_part, jobs))
    else:
        parts = [_part(j) for j in jobs]
    cols = {k: [x for part in parts for x in part["cols"][k]] for k in _COLUMNS}
    if len(cols["content"]) < n_chunks:
        raise ValueError(f"{p['functions']} functions give {len(cols['content'])} chunks, "
                         f"fewer than {n_chunks}")
    cols = {k: v[:n_chunks] for k, v in cols.items()}
    lang_files: dict[str, int] = {}
    for part in parts:
        for k, v in part["langs"].items():
            lang_files[k] = lang_files.get(k, 0) + v
    primary = max(lang_files.items(), key=lambda kv: kv[1])[0]
    group = np.asarray([g for part in parts for g in part["group"]][:n_chunks], np.int64)
    return Chunks(**cols, group=group, names=[n for part in parts for n in part["names"]],
                  writer=CodeWriter(seed, p), primary_language=primary)


def corpus_vectors(group: np.ndarray, dims: int, spread: float, seed: int, device):
    """[N, dims] float32 unit vectors, rounded to bfloat16 (the type the
    vector store serves them in, which its float16 files hold exactly): a
    centre for each group and each vector its centre plus Gaussian noise of
    norm about ``spread``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    g = torch.as_tensor(group, device=device)
    n_groups = int(group.max()) + 1 if len(group) else 0
    centres = torch.nn.functional.normalize(
        torch.randn(n_groups, dims, generator=gen, device=device), dim=-1)
    noise = torch.randn(len(group), dims, generator=gen, device=device)
    v = torch.nn.functional.normalize(centres[g] + noise * (spread / dims ** 0.5), dim=-1)
    return v.to(torch.bfloat16).float()
