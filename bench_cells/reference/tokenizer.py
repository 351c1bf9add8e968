"""Frozen copies of the input preparation the measured program applies to a
text before its encoder sees it: code-aware token splitting, the vocab-free
hashing tokenizer (FNV-1a ids), and the chunk text layout
(Context / Signature / Name / Documentation / Code). Copied so that a change
to the program cannot move the yardstick; plain Python, no imports of the
program."""

from __future__ import annotations

import re

CLS_ID, SEP_ID = 101, 102
RESERVED_IDS = 999
ENCODER_MAX_TOKENS = 512       # the longest input the program's encoder takes

_WORD_RUN_RE = re.compile(rb"[A-Za-z0-9_\x80-\xff]+")
_CAMEL_RE = re.compile(rb"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")
_SEG_SPLIT_RE = re.compile(rb"[^A-Za-z0-9\x80-\xff]+")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _ascii_lower(b: bytes) -> bytes:
    return bytes(c + 32 if 0x41 <= c <= 0x5A else c for c in b)


def code_tokens(text: str) -> list[str]:
    """Identifier subwords (snake_case, camelCase, digit boundaries),
    lowercased, plus the whole lowercased identifier when it splits."""
    raw = text.encode("utf-8", errors="replace")
    out: list[str] = []
    for m in _WORD_RUN_RE.finditer(raw):
        tok = m.group(0)
        subs: list[bytes] = []
        for seg in _SEG_SPLIT_RE.split(tok):
            if not seg:
                continue
            for q in _CAMEL_RE.split(seg):
                if q:
                    subs.append(_ascii_lower(q))
        if len(subs) > 1:
            out.extend(s.decode("utf-8", errors="replace") for s in subs)
            out.append(_ascii_lower(tok).decode("utf-8", errors="replace"))
        elif subs:
            out.append(subs[0].decode("utf-8", errors="replace"))
    return out


def fnv1a64(s: str) -> int:
    h = _FNV_OFFSET
    for b in s.encode("utf-8", errors="replace"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def token_ids(text: str, vocab_size: int, max_len: int) -> list[int]:
    """The hashing tokenizer: [CLS] + hashed tokens + [SEP], at most
    ``max_len`` ids, cut to the encoder's ``ENCODER_MAX_TOKENS``."""
    toks = code_tokens(text)[: max_len - 2]
    space = vocab_size - RESERVED_IDS
    ids = [CLS_ID] + [RESERVED_IDS + fnv1a64(t) % space for t in toks] + [SEP_ID]
    return ids[:ENCODER_MAX_TOKENS]


def clean_docstring(doc: str) -> str:
    out: list[str] = []
    for line in doc.split("\n"):
        t = line.strip()
        if t == "*/":
            t = ""
        else:
            for prefix in ("///", "//!", "//", "/**", "*", '"'):
                if t.startswith(prefix):
                    t = t[len(prefix):].strip()
                    break
        if t:
            out.append(t)
    return " ".join(out).removesuffix('"').strip()


def chunk_text(content: str, context=None, signature=None, docstring=None) -> str:
    """The text a stored chunk is embedded from."""
    parts: list[str] = []
    if context:
        parts.append("Context: " + " > ".join(context))
    if signature:
        parts.append("Signature: " + signature)
        words = signature.split()
        if len(words) >= 2:
            name = words[1].split("<")[0].split("(")[0].split("{")[0]
            if name:
                parts.append("Name: " + name)
    if docstring:
        cleaned = clean_docstring(docstring)
        if cleaned:
            parts.append("Documentation: " + cleaned)
    parts.append("Code:\n" + content)
    return "\n".join(parts)
