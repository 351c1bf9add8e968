"""Chunker: parse source files into semantic chunks.

The reference uses tree-sitter ASTs (src/chunker/). This implementation is a
ground-up *structural scanner*: a lexical masker blanks strings/comments,
then per-language definition-header recognizers plus brace/indent span
tracking recover the definition tree (functions, classes, impls, …) without
a full grammar. The chunk model, breadcrumbs, gap tracking, context windows
and split-with-overlap semantics match the reference
(src/chunker/mod.rs:22-158, semantic.rs:39-487).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..utils.hashing import sha256_hex

DEFAULT_CONTEXT_LINES = 3

# Indexing pipeline params (reference: index/mod.rs:582)
INDEX_MAX_CHUNK_LINES = 100
INDEX_MAX_CHUNK_CHARS = 2000
INDEX_OVERLAP_LINES = 10
# Single-file (watcher) path params (reference: index/manager.rs:1207)
FSW_MAX_CHUNK_LINES = 100
FSW_MAX_CHUNK_CHARS = 4000
FSW_OVERLAP_LINES = 2


class ChunkKind(enum.Enum):
    FUNCTION = "Function"
    CLASS = "Class"
    METHOD = "Method"
    STRUCT = "Struct"
    ENUM = "Enum"
    TRAIT = "Trait"
    INTERFACE = "Interface"
    IMPL = "Impl"
    MOD = "Mod"
    TYPE_ALIAS = "TypeAlias"
    CONST = "Const"
    STATIC = "Static"
    BLOCK = "Block"
    ANCHOR = "Anchor"
    COMMENT = "Comment"
    IMPORTS = "Imports"
    MODULE_DOCS = "ModuleDocs"
    OTHER = "Other"

    @property
    def label_prefix(self) -> str:
        return _LABEL_PREFIX.get(self, "Symbol")


_LABEL_PREFIX = {
    ChunkKind.FUNCTION: "Function",
    ChunkKind.METHOD: "Method",
    ChunkKind.CLASS: "Class",
    ChunkKind.STRUCT: "Struct",
    ChunkKind.ENUM: "Enum",
    ChunkKind.TRAIT: "Trait",
    ChunkKind.INTERFACE: "Interface",
    ChunkKind.IMPL: "Impl",
    ChunkKind.MOD: "Module",
    ChunkKind.TYPE_ALIAS: "Type",
    ChunkKind.CONST: "Const",
    ChunkKind.STATIC: "Static",
    ChunkKind.IMPORTS: "Imports",
    ChunkKind.MODULE_DOCS: "ModuleDocs",
    ChunkKind.COMMENT: "Comment",
}


@dataclass
class Chunk:
    """A chunk of code with metadata (reference: chunker/mod.rs:22-62).

    ``start_line`` is 0-indexed inclusive; ``end_line`` is exclusive (line
    count convention, as in the reference where end = ts row + 1).
    """

    content: str
    start_line: int
    end_line: int
    kind: ChunkKind
    path: str
    context: list[str] = field(default_factory=list)
    signature: str | None = None
    docstring: str | None = None
    is_complete: bool = True
    split_index: int | None = None
    hash: str = ""
    context_prev: str | None = None
    context_next: str | None = None

    def __post_init__(self) -> None:
        if not self.hash:
            self.hash = sha256_hex(self.content)

    @property
    def line_count(self) -> int:
        return max(0, self.end_line - self.start_line)

    @property
    def size_bytes(self) -> int:
        return len(self.content.encode("utf-8", errors="replace"))

    def is_duplicate_of(self, other: "Chunk") -> bool:
        return self.hash == other.hash


from .semantic import SemanticChunker  # noqa: E402,F401
from .dedup import ChunkDeduplicator  # noqa: E402,F401
