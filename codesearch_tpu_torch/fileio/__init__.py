"""File layer: discovery, ignore handling, language + binary detection."""

from .binary import is_binary_content, is_binary_file  # noqa: F401
from .language import Language, detect_language  # noqa: F401
from .walker import FileInfo, FileWalker, WalkStats  # noqa: F401
