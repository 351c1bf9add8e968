"""Doctor: health checks and ``--fix`` (the port of ``codesearch_tpu/cli/doctor.py``;
parity with src/cli/doctor.rs's checks, adapted to the device store: the
LMDB-bloat check becomes a tombstone check, the arroy-tree check a matrix and
manifest consistency check). The stores open read-only for ``device``;
``doctor --device`` adds a torch round trip on the card, run in a child
process under a timeout."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from ..fileio.walker import FileWalker
from ..fts import FtsStore
from ..index.db_discovery import check_integrity, find_best_database
from ..index.file_meta import FileMetaStore, normalize_path
from ..index.pipeline import find_git_root, read_metadata
from ..models import parse_model
from ..utils.constants import FTS_DIR_NAME, get_config_dir
from ..utils.device import resolve_device
from ..utils.hashing import sha256_hex
from ..utils.output import result_print
from ..vectordb import VectorStore

PROBE_TIMEOUT_S = 300.0     # ``doctor --device``'s bound on the probe

# the child of ``check_device_roundtrip``: an 8x8 matmul on the named device,
# read back, then the device's name and the value as one JSON line (torch only)
_PROBE = (
    "import json, sys, torch\n"
    "dev = torch.device(sys.argv[1])\n"
    "x = torch.ones((8, 8), device=dev)\n"
    "v = float((x @ x).cpu()[0, 0])\n"
    "name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'\n"
    "print(json.dumps({'device': name, 'value': v}))\n"
)


@dataclass
class CheckResult:
    name: str
    ok: bool
    detail: str
    fixable: bool = False


def run_checks(path: Path, device=None) -> list[CheckResult]:
    device = resolve_device(device)
    checks: list[CheckResult] = []

    # 1. find database
    db = find_best_database(path)
    if db is None:
        checks.append(CheckResult("database", False,
                                  "no database found — run `codesearch index`"))
        return checks
    checks.append(CheckResult("database", True, str(db)))

    # 2. structure
    integ = check_integrity(db)
    checks.append(CheckResult(
        "structure", integ.valid,
        f"metadata={integ.has_metadata} vectors={integ.has_vectors} fts={integ.has_fts}",
        fixable=not integ.valid))

    # 3. model consistency
    meta = read_metadata(db)
    model = meta.get("model")
    spec = parse_model(model) if model else None
    ok = spec is not None and spec.dims == meta.get("dimensions")
    checks.append(CheckResult(
        "model", ok,
        f"{model} ({meta.get('dimensions')}d)" if ok else f"unknown/mismatched model {model!r}"))

    # 4. git-root placement
    git_root = find_git_root(path.resolve())
    checks.append(CheckResult(
        "placement", git_root is None or db.parent == git_root,
        f"db at {db.parent}, git root {git_root}" if git_root else "no git repo"))

    # 5-8. file and chunk integrity (doctor.rs:230-353): a disk walk with the
    # indexer's own walker and per-file check, stale files, manifest against
    # store ids, sampled content hashes, then tombstones
    dims = int(meta.get("dimensions", 384))
    fm = FileMetaStore.load_or_create(db)
    try:
        store = VectorStore(db, dims=dims, readonly=True, int8=bool(meta.get("int8", False)),
                            device=device)
        manifest_ids = {cid for e in fm.files.values() for cid in e.chunk_ids}
        store_ids = set(store.all_ids())
        ghosts = manifest_ids - store_ids
        orphans = store_ids - manifest_ids
        # walk the project: a local db lives at its root; a global one under
        # the config dir, where the git root or the given path stands in
        if get_config_dir() in db.parents:
            project_root = git_root or path.resolve()
        else:
            project_root = db.parent
        try:
            disk_files, _ = FileWalker(project_root).walk()
        except OSError:
            disk_files = []
        stale = fm.find_deleted_files({str(f.path) for f in disk_files})
        unindexed = up_to_date = outdated = 0
        for f in disk_files:
            if not fm.check_file(Path(f.path)).changed:
                up_to_date += 1
            elif normalize_path(f.path) in fm.files:
                outdated += 1     # tracked, content changed: not an error
            else:
                unindexed += 1
        file_ok = not ghosts and not stale and not unindexed
        checks.append(CheckResult(
            "file_integrity", file_ok,
            f"{len(fm.files)} files tracked; {up_to_date} up to date, "
            f"{outdated} outdated, {unindexed} unindexed, "
            f"{len(stale)} stale (deleted from disk), {len(ghosts)} ghost chunk refs",
            fixable=not file_ok))
        # decode a handful of stored chunks: sha256(content) must be the
        # recorded chunk hash (on-disk metadata corruption)
        sample_ids = sorted(store_ids)[::max(len(store_ids) // 8, 1)][:8]
        bad_hash = 0
        for cid in sample_ids:
            m = store.get_chunk(cid)
            if m is None or (m.hash and sha256_hex(m.content) != m.hash):
                bad_hash += 1
        checks.append(CheckResult(
            "chunk_integrity", not orphans and bad_hash == 0,
            f"{len(store_ids)} chunks; {len(orphans)} orphans (not in manifest); "
            f"{len(sample_ids) - bad_hash}/{len(sample_ids)} sampled content hashes verified",
            fixable=bool(orphans)))
        st = store.stats()
        bloat_ok = st.capacity == 0 or st.tombstones / max(st.capacity, 1) < 0.25
        checks.append(CheckResult("bloat", bloat_ok,
                                  f"{st.tombstones}/{st.capacity} tombstoned rows",
                                  fixable=not bloat_ok))
    except Exception as e:
        checks.append(CheckResult("vector_store", False, f"failed to open: {e}", fixable=True))

    # 9. FTS health (the merge policy keeps at most 12+1 segments)
    try:
        fts = FtsStore(db / FTS_DIR_NAME, readonly=True, device=device)
        st = fts.stats()
        seg_ok = st["segments"] <= 16
        checks.append(CheckResult(
            "fts", seg_ok,
            f"{len(fts)} docs, {st['segments']} segments"
            + ("" if seg_ok else " (merge policy not converging)"),
            fixable=not seg_ok))
        # 10. serving state: score-plane routing and exact-tier sidecars.
        # Sidecars exist only for segments with a term past the prewarm df,
        # so the check fails only when planes are off, which a fresh
        # read-only open never is
        checks.append(CheckResult(
            "serving_state", st["planes_enabled"],
            f"planes {'on' if st['planes_enabled'] else 'OFF'} "
            f"(df floor {fts.plane_df_floor}); "
            f"exact-tier sidecars {st['exact_tier_sidecars']}/{st['segments']} segments"))
    except Exception as e:
        checks.append(CheckResult("fts", False, f"failed to open: {e}", fixable=True))
        checks.append(CheckResult("serving_state", False, f"failed to inspect: {e}"))

    # 11. embedding cache
    cache_root = get_config_dir() / "embedding_cache"
    if cache_root.exists():
        size = sum(f.stat().st_size for f in cache_root.rglob("*") if f.is_file())
        checks.append(CheckResult("embedding_cache", True, f"{size / 1e6:.1f} MB"))
    else:
        checks.append(CheckResult("embedding_cache", True, "empty"))
    return checks


def check_device_roundtrip(timeout_s: float = PROBE_TIMEOUT_S,
                           platform: str = "auto") -> CheckResult:
    """``doctor --device``: an 8x8 matmul on the device (``cuda``, or the
    CPU under ``platform="cpu"``) and its readback, in a child process with
    no stdin, bounded by ``timeout_s``. A child keeps a wedged device from
    hanging the CLI; a timeout, a crash or a wrong value is a failed check."""
    dev = "cpu" if platform == "cpu" else "cuda"
    t0 = time.time()
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE, dev], timeout=timeout_s,
                             stdin=subprocess.DEVNULL, capture_output=True, text=True,
                             check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        ok = res["value"] == 8.0
        return CheckResult(
            "device_roundtrip", ok,
            f"device={res['device']}, round trip {time.time() - t0:.1f}s"
            + ("" if ok else f" (bad value {res['value']})"))
    except subprocess.TimeoutExpired:
        return CheckResult(
            "device_roundtrip", False,
            f"no round trip within {timeout_s:.0f}s — device compute or the "
            "device→host readback is down (searches will hang; use --platform cpu "
            "for small corpora meanwhile)")
    except subprocess.CalledProcessError as e:
        return CheckResult("device_roundtrip", False,
                           f"probe failed (exit {e.returncode}): {(e.stderr or '')[-500:]}")
    except Exception as e:
        return CheckResult("device_roundtrip", False, f"probe failed: {e}")


def run_doctor(path: Path, fix: bool = False, json_out: bool = False,
               device: bool = False, platform: str = "auto") -> int:
    on = "cpu" if platform == "cpu" else None
    checks = run_checks(path, device=on)
    if fix and any(not c.ok and c.fixable for c in checks):
        # the reference's --fix runs an incremental refresh (doctor.rs:489+)
        from ..index.pipeline import index_quiet

        index_quiet(path, device=on)
        checks = run_checks(path, device=on)
    if device:
        checks.append(check_device_roundtrip(PROBE_TIMEOUT_S, platform=platform))
    if json_out:
        result_print(json.dumps([{"name": c.name, "ok": c.ok, "detail": c.detail}
                                 for c in checks], indent=2))
    else:
        for c in checks:
            result_print(f"{'✓' if c.ok else '✗'} {c.name}: {c.detail}")
    return 0 if all(c.ok for c in checks) else 1
