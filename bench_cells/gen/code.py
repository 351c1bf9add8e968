"""Seeded source code for the benchmark's cells: functions in Python, Rust,
TypeScript and Go, grouped into files, with heavy-tailed lengths and
identifiers drawn from a Zipf vocabulary.

Two seeds shape a corpus. The *shape seed* (fixed in the traffic file) draws
the multiset of sizes: lines per function, functions per file, the language
of each file. The *run seed* permutes those sizes and draws every name and
statement, so two seeds do the same amount of work on different text.

Everything emitted is ASCII.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

LANGUAGES = ("Python", "Rust", "TypeScript", "Go")
EXTENSIONS = {"Python": "py", "Rust": "rs", "TypeScript": "ts", "Go": "go"}

_CONSONANTS = "bcdfghjklmnprstvwz"
_VOWELS = "aeiou"
_GLUE = ("the", "a", "of", "for", "to", "in", "with", "from", "and", "when", "each",
         "into", "by", "on", "all", "this", "its", "is", "are", "if", "not")
_PY_TYPES = ("int", "str", "bytes", "float", "list", "dict", "bool")
_RS_TYPES = ("u32", "u64", "i64", "usize", "String", "bool", "f32", "Vec<u8>", "&str")
_TS_TYPES = ("number", "string", "boolean", "unknown", "Buffer", "Date")
_GO_TYPES = ("int", "int64", "string", "bool", "error", "[]byte", "float64")


@dataclass
class Unit:
    """One definition as written: its language, name, kind (the port's
    ``ChunkKind`` value), first line's text, and its source lines."""

    language: str
    name: str
    kind: str
    signature: str
    lines: list[str]


@dataclass
class SourceFile:
    path: str
    language: str
    units: list[Unit]
    header: list[str]

    def text(self) -> str:
        out = list(self.header)
        for u in self.units:
            out.extend(u.lines)
            out.append("")
        return "\n".join(out) + "\n"


def vocabulary(rnd: random.Random, size: int) -> list[str]:
    """``size`` distinct pronounceable words of 3 to 10 letters."""
    words: list[str] = []
    seen: set[str] = set()
    while len(words) < size:
        w = "".join(rnd.choice(_CONSONANTS) + rnd.choice(_VOWELS)
                    + (rnd.choice(_CONSONANTS) if rnd.random() < 0.5 else "")
                    for _ in range(rnd.randint(1, 3)))
        if 3 <= len(w) <= 10 and w not in seen:
            seen.add(w)
            words.append(w)
    return words


def zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def lognormal_lines(rng: np.random.Generator, n: int, median: float, p95: float,
                    cap: int, floor: int) -> np.ndarray:
    """``n`` line counts, lognormal with the given median and 95th percentile,
    clipped to [floor, cap]."""
    sigma = np.log(p95 / median) / 1.6448536269514722
    x = rng.lognormal(np.log(median), sigma, n)
    return np.clip(np.rint(x), floor, cap).astype(np.int64)


@dataclass
class Shape:
    """The sizes of a corpus, fixed by the shape seed."""

    lines: np.ndarray        # lines of each function
    per_file: np.ndarray     # functions in each file
    langs: np.ndarray        # language index of each file


def corpus_shape(p: dict, n_functions: int) -> Shape:
    """Sizes for ``n_functions`` functions: the multiset depends only on the
    traffic's ``shape_seed`` and on ``n_functions``."""
    rng = np.random.default_rng(int(p["shape_seed"]))
    lines = lognormal_lines(rng, n_functions, p["lines_median"], p["lines_p95"],
                            p["lines_cap"], p["lines_floor"])
    per_file = []
    left = n_functions
    lo, hi = p["functions_per_file"]
    while left > 0:
        k = min(left, int(rng.integers(lo, hi + 1)))
        per_file.append(k)
        left -= k
    langs = rng.choice(len(LANGUAGES), size=len(per_file), p=p["language_mix"])
    return Shape(lines, np.asarray(per_file, np.int64), langs)


class CodeWriter:
    """Writes functions from a run seed over a Zipf vocabulary. Bodies are
    drawn from a pool of ``statement_pool`` statements a language (drawn
    once, so a corpus of millions of lines is written in seconds). Names of
    definitions are unique within the writer, so no two functions of a run
    share their text."""

    def __init__(self, seed: int, p: dict, stream: int | None = None):
        """``stream`` draws another sequence over the same vocabulary (one
        of several writers sharing a corpus)."""
        self.rnd = random.Random(seed)
        self.words = vocabulary(self.rnd, int(p["vocabulary"]))
        self.np_rng = np.random.default_rng(seed if stream is None else [seed, stream])
        if stream is not None:
            self.rnd = random.Random(f"{seed}/{stream}")
        self.weights = zipf_weights(len(self.words), float(p["zipf_s"]))
        self.p = p
        self._names: set[str] = set()
        self._files = 0
        self._stream: list[str] = []
        self._idents: dict[tuple, list[str]] = {}
        self._pools: dict[str, list[str]] = {}

    # -- words -------------------------------------------------------------------------------

    def _word(self) -> str:
        if not self._stream:
            idx = self.np_rng.choice(len(self.words), size=1 << 16, p=self.weights)
            self._stream = [self.words[i] for i in idx.tolist()]
        return self._stream.pop()

    def ident(self, style: str, lo: int = 1, hi: int = 3) -> str:
        """An identifier of ``lo`` to ``hi`` Zipf-drawn words in ``style``
        (snake, camel or pascal case), from a batch drawn in bulk."""
        key = (style, lo, hi)
        batch = self._idents.get(key)
        if not batch:
            n = self.np_rng.integers(lo, hi + 1, size=1 << 14).tolist()
            idx = self.np_rng.choice(len(self.words), size=sum(n), p=self.weights).tolist()
            w, at, batch = self.words, 0, []
            for k in n:
                parts = [w[i] for i in idx[at:at + k]]
                at += k
                if style == "snake":
                    batch.append("_".join(parts))
                elif style == "camel":
                    batch.append(parts[0] + "".join(p.capitalize() for p in parts[1:]))
                else:
                    batch.append("".join(p.capitalize() for p in parts))
            self._idents[key] = batch
        return batch.pop()

    def def_name(self, style: str) -> str:
        """A fresh name of two or three words for a definition."""
        while True:
            name = self.ident(style, 2, 3)
            if name not in self._names:
                self._names.add(name)
                return name

    def phrase(self, lo: int, hi: int) -> str:
        return " ".join(self.rnd.choice(_GLUE) if self.rnd.random() < 0.3 else self._word()
                        for _ in range(self.rnd.randint(lo, hi)))

    def pick(self, seq):
        return self.rnd.choice(seq)

    def _pool(self, key, make) -> list[str]:
        """``statement_pool`` values of ``make()``, drawn once a run."""
        pool = self._pools.get(key)
        if pool is None:
            pool = self._pools[key] = [make() for _ in range(int(self.p["statement_pool"]))]
        return pool

    def body(self, language: str, n: int, indent: str) -> list[str]:
        """``n`` statements of ``language`` at ``indent``, from its pool."""
        make = {"Python": self._py_stmt, "Rust": self._rs_stmt,
                "TypeScript": self._ts_stmt, "Go": self._go_stmt}[language]
        pool = self._pool((language, indent), lambda: indent + make())
        return self.rnd.choices(pool, k=n)

    def _args(self, language: str) -> str:
        """A parameter list (without a receiver), from the language's pool."""
        style, sep, types = {"Python": ("snake", ": ", _PY_TYPES),
                             "Rust": ("snake", ": ", _RS_TYPES),
                             "TypeScript": ("camel", ": ", _TS_TYPES),
                             "Go": ("camel", " ", _GO_TYPES)}[language]
        pool = self._pool(("args", language), lambda: ", ".join(
            f"{self.ident(style)}{sep}{self.pick(types)}" for _ in range(self.rnd.randrange(4))))
        return self.rnd.choice(pool)

    def _doc(self) -> str:
        return self.rnd.choice(self._pool("doc", lambda: self.phrase(4, 12)))

    # -- statements --------------------------------------------------------------------------

    def _py_stmt(self) -> str:
        r = self.rnd.random()
        a, b, c = self.ident("snake"), self.ident("snake"), self.ident("snake")
        if r < 0.35:
            return f"{a} = {b}({c}, {self.ident('snake')})"
        if r < 0.5:
            return f"{a} = self.{b}.{c}({self.rnd.randrange(512)})"
        if r < 0.62:
            return f"if {a} is None or {b} > {self.rnd.randrange(1, 100)}: {c} += 1"
        if r < 0.72:
            return f"for {a} in {b}: {c}.append({a})"
        if r < 0.84:
            return f"# {self.phrase(3, 9)}"
        if r < 0.92:
            return f'log.debug("{self.phrase(2, 6)} %s", {a})'
        return f"{a}[{b!r}] = {c}"

    def _rs_stmt(self) -> str:
        r = self.rnd.random()
        a, b, c = self.ident("snake"), self.ident("snake"), self.ident("snake")
        if r < 0.35:
            return f"let {a} = {b}(&{c}, {self.ident('snake')});"
        if r < 0.5:
            return f"let mut {a}: {self.pick(_RS_TYPES)} = self.{b}.{c}()?;"
        if r < 0.62:
            return f"if {a}.is_empty() {{ return Err(Error::{self.ident('pascal')}); }}"
        if r < 0.72:
            return f"for {a} in {b}.iter() {{ {c}.push(*{a}); }}"
        if r < 0.84:
            return f"// {self.phrase(3, 9)}"
        if r < 0.92:
            return f'debug!("{self.phrase(2, 6)} {{}}", {a});'
        return f"{a}.insert({b}, {c});"

    def _ts_stmt(self) -> str:
        r = self.rnd.random()
        a, b, c = self.ident("camel"), self.ident("camel"), self.ident("camel")
        if r < 0.35:
            return f"const {a} = {b}({c}, {self.ident('camel')});"
        if r < 0.5:
            return f"let {a}: {self.pick(_TS_TYPES)} = this.{b}.{c}();"
        if r < 0.62:
            return f"if (!{a} || {b}.length > {self.rnd.randrange(1, 100)}) {{ {c} += 1; }}"
        if r < 0.72:
            return f"for (const {a} of {b}) {{ {c}.push({a}); }}"
        if r < 0.84:
            return f"// {self.phrase(3, 9)}"
        if r < 0.92:
            return f"logger.debug(`{self.phrase(2, 6)} ${{{a}}}`);"
        return f"{a}.set({b}, {c});"

    def _go_stmt(self) -> str:
        r = self.rnd.random()
        a, b, c = self.ident("camel"), self.ident("camel"), self.ident("camel")
        if r < 0.35:
            return f"{a} := {b}({c}, {self.ident('camel')})"
        if r < 0.5:
            return f"{a}, err := s.{b}.{self.ident('pascal')}()"
        if r < 0.62:
            return f"if err != nil {{ return {a}, fmt.Errorf(\"{self.phrase(2, 4)}: %w\", err) }}"
        if r < 0.72:
            return f"for _, {a} := range {b} {{ {c} = append({c}, {a}) }}"
        if r < 0.84:
            return f"// {self.phrase(3, 9)}"
        if r < 0.92:
            return f"log.Printf(\"{self.phrase(2, 6)} %v\", {a})"
        return f"{a}[{b}] = {c}"

    # -- definitions -------------------------------------------------------------------------

    def unit(self, language: str, n_lines: int, method_of: str | None) -> Unit:
        """A definition of ``n_lines`` lines (signature and closing line
        included; at least 2)."""
        body_n = max(1, n_lines - 2)
        doc = self._doc()
        args = self._args(language)
        kind = "Method" if method_of else "Function"
        if language == "Python":
            name = self.def_name("snake")
            if method_of:
                args = "self, " + args if args else "self"
            ind = "        " if method_of else "    "
            sig = f"def {name}({args}) -> {self.pick(_PY_TYPES)}:"
            lines = [ind[4:] + sig, f'{ind}"""{doc.capitalize()}."""',
                     *self.body(language, body_n - 1, ind), f"{ind}return {self.ident('snake')}"]
        elif language == "Rust":
            name = self.def_name("snake")
            if method_of:
                args = "&self, " + args if args else "&self"
            ind = "        " if method_of else "    "
            sig = f"pub fn {name}({args}) -> Result<{self.pick(_RS_TYPES)}, Error> {{"
            lines = [f"{ind[4:]}/// {doc.capitalize()}.", ind[4:] + sig,
                     *self.body(language, body_n - 1, ind), f"{ind}Ok({self.ident('snake')})",
                     ind[4:] + "}"]
        elif language == "TypeScript":
            name = self.def_name("camel")
            ind = "    " if method_of else "  "
            head = f"{name}(" if method_of else f"export function {name}("
            sig = f"{head}{args}): {self.pick(_TS_TYPES)} {{"
            lines = [f"{ind[2:]}/** {doc.capitalize()}. */", ind[2:] + sig,
                     *self.body(language, body_n - 1, ind),
                     f"{ind}return {self.ident('camel')};", ind[2:] + "}"]
        else:
            name = self.def_name("pascal" if self.rnd.random() < 0.5 else "camel")
            recv = f"(s *{method_of}) " if method_of else ""
            sig = f"func {recv}{name}({args}) ({self.pick(_GO_TYPES)}, error) {{"
            lines = [f"// {name} {doc}.", sig, *self.body(language, body_n - 1, "\t"),
                     f"\treturn {self.ident('camel')}, nil", "}"]
        return Unit(language, name, kind, sig.strip(), lines)

    def source_file(self, path: str, language: str, sizes: list[int]) -> SourceFile:
        """A file holding one definition a size; in about a third of the
        files the definitions are methods of one class (Python, TypeScript),
        ``impl`` block (Rust) or receiver type (Go)."""
        owner = self.def_name("pascal") if self.rnd.random() < 0.33 else None
        units = [self.unit(language, int(n), owner) for n in sizes]
        header = self._header(language)
        if owner is None:
            return SourceFile(path, language, units, header)
        if language == "Python":
            header.append(f"class {owner}:")
            header.append(f'    """{self.phrase(4, 10).capitalize()}."""')
        elif language == "Rust":
            header.append(f"pub struct {owner} {{ {self.ident('snake')}: u64 }}")
            header.append("")
            header.append(f"impl {owner} {{")
            units[-1].lines.append("}")
        elif language == "TypeScript":
            header.append(f"export class {owner} {{")
            units[-1].lines.append("}")
        else:
            header.append(f"type {owner} struct {{ {self.ident('camel')} int }}")
        return SourceFile(path, language, units, header)

    def _header(self, language: str) -> list[str]:
        """Imports; the first names a module of the writer's own, numbered,
        so that no two files of a run share their header's text."""
        self._files += 1
        mods = [f"{self.ident('snake', 1, 1)}_v{self._files}",
                *(self.ident("snake", 1, 2) for _ in range(self.rnd.randint(0, 2)))]
        if language == "Python":
            return [f"import {m}" for m in mods] + [""]
        if language == "Rust":
            return [f"use crate::{m};" for m in mods] + [""]
        if language == "TypeScript":
            return [f'import {{ {self.ident("camel")} }} from "./{m}";' for m in mods] + [""]
        return ["package " + mods[0].replace("_", ""), "",
                "import (", *(f'\t"{m.replace("_", "/")}"' for m in mods), ")", ""]

    def files(self, shape: Shape, prefix: str) -> list[SourceFile]:
        """The files of ``shape`` in this writer's order: function sizes and
        file sizes permuted by the run seed."""
        return self.write(*permuted(shape, self.np_rng), prefix)

    def write(self, lines, per_file, langs, prefix: str, first: int = 0) -> list[SourceFile]:
        """Files of ``per_file`` functions each, of ``lines`` lines in order,
        in the languages ``langs``; numbered from ``first``."""
        out, at = [], 0
        dirs = [self.ident("snake", 1, 1) for _ in range(max(1, len(per_file) // 24))]
        for i, (k, li) in enumerate(zip(per_file, langs)):
            lang = LANGUAGES[int(li)]
            stem = self.ident("snake", 1, 2)
            path = f"{prefix}{dirs[i % len(dirs)]}/{stem}_{first + i}.{EXTENSIONS[lang]}"
            out.append(self.source_file(path, lang, list(lines[at:at + k])))
            at += k
        return out


def permuted(shape: Shape, rng: np.random.Generator):
    """(lines, functions a file, languages) of ``shape`` in ``rng``'s order."""
    return rng.permutation(shape.lines), rng.permutation(shape.per_file), \
        rng.permutation(shape.langs)
