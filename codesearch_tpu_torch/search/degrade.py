"""Device-OOM degrade (the port of ``codesearch_tpu/search/degrade.py``):
on a CUDA out-of-memory error with score planes enabled, release the
resident BM25 score planes and run the query once more on the
allocation-light sparse leg — degrade and continue rather than fail the
query."""

from __future__ import annotations

import torch

from ..utils.logger import get_logger

log = get_logger("search")


def is_device_oom(e: Exception) -> bool:
    """True for a CUDA out-of-memory error, the one the port's device path
    can raise."""
    return isinstance(e, torch.OutOfMemoryError)


def dispatch_with_degrade(fts, fn, what: str):
    """Run ``fn()``; on a device OOM with planes enabled, release them and
    run it once more. Anything else, a second OOM included, propagates.
    ``fts`` may be None (nothing to release, so nothing to retry)."""
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
