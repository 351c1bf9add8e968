"""Per-file metadata manifest for incremental indexing.

Parity with the reference FileMetaStore (src/cache/file_meta.rs:49-300):
JSON ``file_meta.json`` mapping normalized path → {sha256, mtime, size,
chunk_count, chunk_ids}; two-level change detection (mtime+size fast path,
content hash slow path); model-change invalidation; deleted-file discovery.
This manifest is also the resume checkpoint: a cancelled index run leaves a
consistent-but-partial DB that the next run completes (SURVEY.md §5).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

from ..utils.constants import FILE_META_DB_NAME
from ..utils.hashing import sha256_file
from ..utils.logger import get_logger

log = get_logger("file_meta")


def normalize_path(path: str | Path) -> str:
    """Canonical manifest key: forward slashes, Windows extended-length
    (``\\\\?\\``) prefix stripped, ``.`` segments and duplicate slashes
    collapsed (parity with cache/file_meta.rs:17-25 and its UNC matrix)."""
    s = str(path).replace("\\", "/")
    if s.startswith("//?/"):
        s = s[4:]
    parts = []
    for i, seg in enumerate(s.split("/")):
        if seg == "." or (seg == "" and i > 0):
            continue
        parts.append(seg)
    return "/".join(parts)


@dataclass
class FileEntry:
    sha256: str
    mtime: float
    size: int
    chunk_count: int = 0
    chunk_ids: list[int] = field(default_factory=list)


@dataclass
class FileCheck:
    changed: bool
    reason: str  # "new" | "mtime" | "hash" | "unchanged"
    sha256: str | None = None


class FileMetaStore:
    def __init__(self, db_path: str | Path, model_name: str = ""):
        self.db_path = Path(db_path)
        self.model_name = model_name
        self.files: dict[str, FileEntry] = {}
        self._loaded_model = ""

    @property
    def path(self) -> Path:
        return self.db_path / FILE_META_DB_NAME

    @classmethod
    def load_or_create(cls, db_path: str | Path, model_name: str = "") -> "FileMetaStore":
        store = cls(db_path, model_name)
        p = store.path
        if p.exists():
            try:
                raw = json.loads(p.read_text())
                store._loaded_model = raw.get("model", "")
                if model_name and store._loaded_model and store._loaded_model != model_name:
                    # model change ⇒ full invalidation (file_meta.rs:86-92)
                    log.info(
                        "model changed (%s → %s): invalidating file metadata",
                        store._loaded_model, model_name,
                    )
                    store.files = {}
                else:
                    store.files = {
                        normalize_path(k): FileEntry(**v)
                        for k, v in raw.get("files", {}).items()
                    }
            except (json.JSONDecodeError, TypeError, OSError) as e:
                log.warning("corrupt file_meta.json, starting fresh: %s", e)
                store.files = {}
        return store

    def save(self) -> None:
        self.db_path.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        payload = {
            "model": self.model_name,
            "files": {k: v.__dict__ for k, v in self.files.items()},
        }
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, self.path)

    # ------------------------------------------------------------------

    def check_file(self, path: Path) -> FileCheck:
        """Two-level change check: mtime+size fast path, sha256 slow path."""
        key = normalize_path(path)
        entry = self.files.get(key)
        try:
            st = path.stat()
        except OSError:
            return FileCheck(changed=True, reason="new")
        if entry is None:
            return FileCheck(changed=True, reason="new")
        if entry.mtime == st.st_mtime and entry.size == st.st_size:
            return FileCheck(changed=False, reason="unchanged", sha256=entry.sha256)
        digest = sha256_file(path)
        if digest == entry.sha256:
            # touched but identical — refresh stat fields
            entry.mtime = st.st_mtime
            entry.size = st.st_size
            return FileCheck(changed=False, reason="unchanged", sha256=digest)
        return FileCheck(changed=True, reason="hash", sha256=digest)

    def update_file(
        self, path: Path, chunk_ids: list[int], sha256: str | None = None
    ) -> None:
        key = normalize_path(path)
        try:
            st = path.stat()
            mtime, size = st.st_mtime, st.st_size
        except OSError:
            mtime, size = 0.0, 0
        self.files[key] = FileEntry(
            sha256=sha256 or sha256_file(path),
            mtime=mtime,
            size=size,
            chunk_count=len(chunk_ids),
            chunk_ids=list(chunk_ids),
        )

    def remove_file(self, path: str | Path) -> list[int]:
        entry = self.files.pop(normalize_path(path), None)
        return entry.chunk_ids if entry else []

    def find_deleted_files(self, existing: set[str]) -> list[str]:
        """Tracked paths no longer on disk (file_meta.rs:225)."""
        existing_norm = {normalize_path(p) for p in existing}
        return [p for p in self.files if p not in existing_norm]

    def chunk_ids_for(self, path: str | Path) -> list[int]:
        entry = self.files.get(normalize_path(path))
        return entry.chunk_ids if entry else []

    def total_chunks(self) -> int:
        return sum(e.chunk_count for e in self.files.values())
