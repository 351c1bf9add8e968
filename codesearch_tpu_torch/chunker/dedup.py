"""Hash-keyed chunk deduplication (reference: src/chunker/dedup.rs:17-108).

First occurrence of a content hash wins; later duplicates (license headers,
vendored/generated code) are dropped. Tracks stats.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import Chunk


@dataclass
class DedupStats:
    total_seen: int = 0
    unique: int = 0
    duplicates: int = 0


@dataclass
class ChunkDeduplicator:
    seen: set[str] = field(default_factory=set)
    stats: DedupStats = field(default_factory=DedupStats)

    def deduplicate(self, chunks: list[Chunk]) -> list[Chunk]:
        out: list[Chunk] = []
        for c in chunks:
            self.stats.total_seen += 1
            if c.hash in self.seen:
                self.stats.duplicates += 1
                continue
            self.seen.add(c.hash)
            self.stats.unique += 1
            out.append(c)
        return out

    def reset(self) -> None:
        self.seen.clear()
        self.stats = DedupStats()
