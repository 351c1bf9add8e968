"""Typed error hierarchy (reference: src/error.rs:10-174)."""

from __future__ import annotations


class CodeSearchError(Exception):
    """Base class for all codesearch_tpu errors."""


class DatabaseError(CodeSearchError):
    pass


class EmbeddingError(CodeSearchError):
    pass


class SearchError(CodeSearchError):
    pass


class IndexError_(CodeSearchError):
    """Indexing failure (trailing underscore avoids shadowing the builtin)."""


class ConfigError(CodeSearchError):
    pass


class McpError(CodeSearchError):
    pass


class ParseError(CodeSearchError):
    pass


class ValidationError(CodeSearchError):
    pass
