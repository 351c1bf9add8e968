"""Device-OOM degrade (port of ``codesearch_tpu/search/degrade.py``): on a
device out-of-memory error with score planes enabled, release the planes
and run the query once more on the sparse BM25 leg."""

from __future__ import annotations

import torch

from codesearch_tpu.search.degrade import is_device_oom as _is_xla_oom
from codesearch_tpu.utils.logger import get_logger

log = get_logger("search")


def is_device_oom(e: Exception) -> bool:
    """True for a CUDA out-of-memory error (or the JAX package's textual
    RESOURCE_EXHAUSTED memory error)."""
    return isinstance(e, torch.OutOfMemoryError) or _is_xla_oom(e)


def dispatch_with_degrade(fts, fn, what: str):
    """Run ``fn()``; on a device OOM with planes enabled, release them and
    run it once more. Anything else, a second OOM included, propagates."""
    try:
        return fn()
    except Exception as e:
        if fts is None or not is_device_oom(e) or not fts.planes_enabled:
            raise
        log.warning("device out of memory during %s — releasing score planes "
                    "and retrying on the sparse BM25 leg: %s", what,
                    str(e).splitlines()[0] if str(e) else type(e).__name__)
        fts.release_planes()
        return fn()
