"""Host-side tokenization.

Three tiers:

1. ``HFTokenizer`` — wraps a local ``tokenizer.json`` via the ``tokenizers``
   library when model assets exist in the models cache (exact parity with
   the reference's fastembed tokenization).
2. ``WordPieceTokenizer`` — self-contained BERT WordPiece (basic splitting +
   greedy longest-match) loading a local ``vocab.txt``.
3. ``HashingTokenizer`` — deterministic, vocab-free: code-aware token
   splitting (camelCase / snake_case / punctuation) with ids assigned by
   stable hashing. Powers the weights-free hash embedder and random-init
   perf runs; needs zero downloaded assets.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from pathlib import Path

from ..utils.hashing import stable_u64

PAD_ID, UNK_ID, CLS_ID, SEP_ID = 0, 100, 101, 102  # BERT conventions


@dataclass
class Encoded:
    ids: list[int]
    # attention length (ids are NOT padded here; batching pads)


# Tokenization is defined byte-wise over UTF-8 so the native C++ tier
# (native/cs_native.cpp) produces byte-identical output: word bytes are
# ASCII alphanumerics, '_' and any byte >= 0x80; camel boundaries are
# ASCII-only; lowercasing is ASCII-only.
_WORD_RUN_RE = re.compile(rb"[A-Za-z0-9_\x80-\xff]+")
_CAMEL_RE = re.compile(rb"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")
_SEG_SPLIT_RE = re.compile(rb"[^A-Za-z0-9\x80-\xff]+")


def _ascii_lower(b: bytes) -> bytes:
    return bytes(c + 32 if 0x41 <= c <= 0x5A else c for c in b)


def split_identifier(token: str) -> list[str]:
    """Split code identifiers: snake_case, camelCase, digit boundaries."""
    raw = token.encode("utf-8", errors="replace")
    parts: list[str] = []
    for seg in _SEG_SPLIT_RE.split(raw):
        if not seg:
            continue
        for q in _CAMEL_RE.split(seg):
            if q:
                parts.append(_ascii_lower(q).decode("utf-8", errors="replace"))
    return parts


def code_tokens(text: str) -> list[str]:
    """Tokenize text for the hash embedder / FTS: identifier subwords plus
    the whole lowercased identifier (exact-name signal)."""
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


class HashingTokenizer:
    """Vocab-free tokenizer: stable-hash token ids into a fixed id space."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 512):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self._reserved = 999  # ids < reserved are special/unused

    def encode(self, text: str) -> Encoded:
        toks = code_tokens(text)[: self.max_len - 2]
        space = self.vocab_size - self._reserved
        ids = [CLS_ID] + [
            self._reserved + (stable_u64(t) % space) for t in toks
        ] + [SEP_ID]
        return Encoded(ids=ids)


class WordPieceTokenizer:
    """Self-contained BERT WordPiece tokenizer over a local vocab.txt."""

    def __init__(self, vocab_path: Path, lowercase: bool = True, max_len: int = 512):
        self.vocab: dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.lowercase = lowercase
        self.max_len = max_len
        self.unk = self.vocab.get("[UNK]", UNK_ID)
        self.cls = self.vocab.get("[CLS]", CLS_ID)
        self.sep = self.vocab.get("[SEP]", SEP_ID)
        self.pad = self.vocab.get("[PAD]", PAD_ID)

    _BASIC_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)

    def _basic_tokens(self, text: str) -> list[str]:
        if self.lowercase:
            text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        return self._BASIC_RE.findall(text)

    def _wordpiece(self, token: str) -> list[int]:
        if len(token) > 100:
            return [self.unk]
        ids: list[int] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> Encoded:
        ids: list[int] = [self.cls]
        budget = self.max_len - 2
        for tok in self._basic_tokens(text):
            piece = self._wordpiece(tok)
            if len(ids) - 1 + len(piece) > budget:
                break
            ids.extend(piece)
        ids.append(self.sep)
        return Encoded(ids=ids)


class HFTokenizer:
    """tokenizer.json via the `tokenizers` library (local files only)."""

    def __init__(self, tokenizer_json: Path, max_len: int = 512):
        from tokenizers import Tokenizer  # local import; lib is baked in

        self.tk = Tokenizer.from_file(str(tokenizer_json))
        self.tk.enable_truncation(max_length=max_len)
        self.max_len = max_len

    def encode(self, text: str) -> Encoded:
        return Encoded(ids=self.tk.encode(text).ids)


def load_tokenizer(model_dir: Path | None, lowercase: bool, max_len: int,
                   vocab_size: int = 30522):
    """Best local tokenizer for a model: tokenizer.json > vocab.txt > hashing."""
    if model_dir is not None:
        tj = model_dir / "tokenizer.json"
        if tj.exists():
            return HFTokenizer(tj, max_len=max_len)
        vt = model_dir / "vocab.txt"
        if vt.exists():
            return WordPieceTokenizer(vt, lowercase=lowercase, max_len=max_len)
    return HashingTokenizer(vocab_size=vocab_size, max_len=max_len)
