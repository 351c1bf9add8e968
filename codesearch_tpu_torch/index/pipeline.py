"""Indexing pipeline on torch (port of ``codesearch_tpu/index/pipeline.py``).

The orchestration is the JAX package's: walk, diff against the file
manifest, chunk, embed in slabs with one slab in flight, insert into the
vector and FTS stores, commit. It is repeated here because the JAX version
builds its stores and embedding service by module-global name; the port's
are built on ``device``. Every host helper (database placement, metadata,
the file manifest, chunker, walker) is imported, so both packages write one
on-disk format.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

from codesearch_tpu.chunker import (
    INDEX_MAX_CHUNK_CHARS,
    INDEX_MAX_CHUNK_LINES,
    INDEX_OVERLAP_LINES,
    SemanticChunker,
)
from codesearch_tpu.chunker.dedup import ChunkDeduplicator
from codesearch_tpu.fileio import FileWalker
from codesearch_tpu.index.file_meta import FileMetaStore, normalize_path
from codesearch_tpu.index.pipeline import (
    EMBED_FILES_PER_BATCH,
    FTS_COMMIT_EVERY,
    IndexOptions,
    IndexStats,
    ensure_db_ignored,
    get_db_path_smart,
    read_metadata,
    write_metadata,
)
from codesearch_tpu.utils.constants import (
    EMBEDDER_VERSION,
    FTS_DIR_NAME,
    is_shutdown_requested,
)
from codesearch_tpu.utils.output import ProgressLine, info_print, warn_print
from codesearch_tpu.vectordb.store import ChunkMetadata

from ..embed import EmbeddingService
from ..fts import FtsStore
from ..vectordb import VectorStore

__all__ = ["IndexOptions", "IndexStats", "index"]


def index(path: str | Path = ".", options: IndexOptions | None = None,
          device=None) -> IndexStats:
    """Full or incremental index of a repository; stores open from the
    resolved database path on ``device``."""
    options = options or IndexOptions()
    t0 = time.time()
    project = Path(path).resolve()
    db_path, root = get_db_path_smart(project, options.store_path, options.force,
                                      options.global_db)
    stats = IndexStats(db_path=db_path, int8=options.int8)
    if options.dry_run:
        raise NotImplementedError("index --dry-run is not ported yet (ROADMAP.md Queue 1)")

    if options.force and db_path.exists():
        info_print(f"force rebuild: deleting {db_path}")
        shutil.rmtree(db_path, ignore_errors=True)
    meta = read_metadata(db_path)
    model_name = meta.get("model", options.model) if not options.force else options.model
    service = EmbeddingService(model_name, db_path=db_path, device=device)
    if meta and meta.get("embedder_version", 1) != EMBEDDER_VERSION:
        info_print(f"embedder version changed (v{meta.get('embedder_version', 1)} "
                   f"→ v{EMBEDDER_VERSION}): full rebuild")
        shutil.rmtree(db_path, ignore_errors=True)
        meta = {}

    db_path.mkdir(parents=True, exist_ok=True)
    if db_path.parent == root:
        ensure_db_ignored(root)
    stats.int8 = options.int8 or bool(meta.get("int8", False))
    store = VectorStore(db_path, dims=service.dims, int8=stats.int8, device=device)
    fts = FtsStore(db_path / FTS_DIR_NAME, device=device)
    file_meta = FileMetaStore.load_or_create(db_path, service.model_name)

    # ---- walk + incremental diff ----------------------------------------
    files, walk_stats = FileWalker(root, extra_excludes=list(options.extra_excludes)).walk()
    stats.files_walked = len(files)
    if walk_stats.by_language:
        stats.primary_language = max(walk_stats.by_language.items(), key=lambda kv: kv[1])[0]
    changed: list = []
    hashes: dict[str, str] = {}
    for f in files:
        check = file_meta.check_file(f.path)
        if check.changed:
            changed.append(f)
            if check.sha256:
                hashes[normalize_path(f.path)] = check.sha256
        else:
            stats.files_unchanged += 1
    for dpath in file_meta.find_deleted_files({str(f.path) for f in files}):
        old_ids = file_meta.remove_file(dpath)
        if old_ids:
            stats.chunks_deleted += store.delete_chunks(old_ids)
            for cid in old_ids:
                fts.delete_chunk(cid)
        stats.files_deleted += 1
    info_print(f"indexing {len(changed)} changed files "
               f"({stats.files_unchanged} unchanged, {stats.files_deleted} deleted)")

    # ---- chunk -> embed -> insert, one embed slab in flight ---------------
    chunker = SemanticChunker(INDEX_MAX_CHUNK_LINES, INDEX_MAX_CHUNK_CHARS, INDEX_OVERLAP_LINES)
    deduper = ChunkDeduplicator() if options.dedup else None
    progress = ProgressLine(len(changed))
    since_commit = 0
    pending = None

    def _finalize(p) -> None:
        nonlocal since_commit
        per_file, flat, finish = p
        ids: list[int] = []
        if flat:
            embs = finish()
            metas = [
                ChunkMetadata(
                    path=c.path, content=c.content, start_line=c.start_line,
                    end_line=c.end_line, kind=c.kind.value, context=c.context,
                    signature=c.signature, docstring=c.docstring, hash=c.hash,
                    language=getattr(c, "_language", None))
                for c in flat
            ]
            ids = store.insert_chunks_with_ids(embs, metas)
            try:
                fts.add_chunks([(cid, m.content, m.path, m.signature, m.kind)
                                for cid, m in zip(ids, metas)])
                since_commit += len(ids)
                if since_commit >= FTS_COMMIT_EVERY:
                    fts.commit()
                    since_commit = 0
            except Exception as e:  # FTS failures are non-fatal: vectors stay usable
                warn_print(f"FTS indexing failed (vector search unaffected): {e}")
            stats.chunks_added += len(flat)
        cursor = 0
        for fpath, cs in per_file:
            file_meta.update_file(fpath, ids[cursor:cursor + len(cs)],
                                  hashes.get(normalize_path(fpath)))
            cursor += len(cs)
        stats.files_indexed += len(per_file)
        progress.update(stats.files_indexed, extra=f", {stats.chunks_added} chunks")

    i = 0
    while i < len(changed):
        if is_shutdown_requested():
            progress.finish()
            info_print("cancelling — committing partial progress …")
            stats.cancelled = True
            break
        batch_files = changed[i:i + EMBED_FILES_PER_BATCH]
        i += len(batch_files)
        per_file: list[tuple[Path, list]] = []
        for f in batch_files:
            try:
                content = f.path.read_text(encoding="utf-8", errors="replace")
            except OSError:
                continue
            rel = f.path.relative_to(root) if f.path.is_relative_to(root) else f.path
            chunks = chunker.chunk_semantic(f.language, rel, content)
            if deduper is not None:
                chunks = deduper.deduplicate(chunks)
            for c in chunks:
                c._language = f.language.display_name  # type: ignore[attr-defined]
            per_file.append((f.path, chunks))
        for fpath, _ in per_file:
            old_ids = file_meta.chunk_ids_for(fpath)
            if old_ids:
                stats.chunks_deleted += store.delete_chunks(old_ids)
                for cid in old_ids:
                    fts.delete_chunk(cid)
        flat = [c for _, cs in per_file for c in cs]
        finish = service.embed_chunks_matrix_async(flat) if flat else None
        if pending is not None:
            _finalize(pending)
        pending = (per_file, flat, finish)
    if pending is not None:
        _finalize(pending)

    # ---- finalize -----------------------------------------------------------
    progress.finish()
    store.build_index()
    store.save()
    try:
        fts.commit()
    except Exception as e:  # non-fatal, as above
        warn_print(f"FTS commit failed: {e}")
    file_meta.save()
    write_metadata(db_path, service, stats)
    if deduper is not None:
        stats.chunks_deduped = deduper.stats.duplicates
    stats.elapsed_s = time.time() - t0
    if stats.cancelled:
        info_print("indexing cancelled — partial progress saved; re-run to complete")
    return stats
