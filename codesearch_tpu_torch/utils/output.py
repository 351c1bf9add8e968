"""Quiet-mode aware console output.

stdout is reserved for results and JSON-RPC frames (the MCP server speaks
JSON-RPC over stdout); all human-facing chatter goes to stderr and is
suppressed entirely in quiet mode. Mirrors the reference's output discipline
(src/output.rs:96-141) — a source-scanning test asserts no stray ``print``
calls in server/search modules.
"""

from __future__ import annotations

import sys
import threading

_QUIET = False
_LOCK = threading.Lock()

# stderr lines containing any of these are spurious native-library spam
# (see install_native_log_filter). Deliberately NARROW: XLA's AOT loader
# complains about its own tuning pseudo-features (+prefer-no-scatter /
# +prefer-no-gather), which never appear in a host CPUID list — so the
# line fires even on the very host that wrote the cache entry. A GENUINE
# cross-machine mismatch names a real ISA feature ("Target machine
# feature +avx512f is not supported") and passes through, preserving the
# one diagnostic that precedes a SIGILL.
NATIVE_SPAM_PATTERNS = (b"Target machine feature +prefer-no-",)
_FILTER_STATE: dict | None = None
_STDERR_WAS_TTY: bool | None = None


def stderr_isatty() -> bool:
    """Is the REAL stderr a terminal? Survives install_native_log_filter
    replacing fd 2 with a pipe (a plain ``sys.stderr.isatty()`` would
    report False and progress displays would stop live-updating)."""
    if _STDERR_WAS_TTY is not None:
        return _STDERR_WAS_TTY
    try:
        return sys.stderr.isatty()
    except Exception:
        return False


def _might_be_spam_prefix(tail: bytes) -> bool:
    """Could ``tail`` (an incomplete stderr line) still grow into a spam
    line? Native glog lines look like ``E0818 01:52:07.357736  8967
    cpu_aot_loader.cc:210] ...`` — the source file appears within the
    first ~64 bytes. Anything else is forwarded immediately so
    interactive \\r progress updates keep streaming."""
    if any(p in tail for p in NATIVE_SPAM_PATTERNS):
        return True
    if not tail or len(tail) >= 256 or tail[0:1] not in b"EWIF":
        return False
    # one-byte tail: could still become a glog prefix — hold it (forwarding
    # would strand an orphan severity byte when the rest gets dropped)
    return len(tail) == 1 or tail[1:2].isdigit()


def install_native_log_filter() -> None:
    """Drop spurious native-library stderr spam at the file-descriptor
    level (idempotent; restored by atexit).

    XLA's AOT-cache loader logs a ~6KB machine-feature-mismatch error for
    EVERY persistent-compile-cache hit on the CPU backend: the
    compile-side feature list embeds tuning pseudo-features
    (``+prefer-no-scatter``) that never appear in the host CPUID list, so
    the mismatch fires even on the very host that wrote the entry (the
    executables load and run fine — measured). The TSL log threshold
    latches when jax is imported, which happens before any of our code in
    environments that pre-import jax at interpreter startup, so
    TF_CPP_MIN_LOG_LEVEL cannot silence it. Instead fd 2 is routed
    through a pipe whose pump thread drops matching lines and forwards
    everything else to the original stderr. Complete lines are filtered
    exactly; an incomplete tail is forwarded immediately unless it could
    still be a match prefix (_might_be_spam_prefix), so partial writes
    and \\r progress updates are not delayed. This is the analog of the
    reference's per-crate log suppression (src/logger/mod.rs:222-227:
    ``tantivy=warn,arroy=warn,ort=warn``)."""
    global _FILTER_STATE, _STDERR_WAS_TTY
    with _LOCK:
        if _FILTER_STATE is not None:
            return
        import atexit
        import os

        try:
            _STDERR_WAS_TTY = os.isatty(2)
        except OSError:
            _STDERR_WAS_TTY = False

        try:
            real = os.dup(2)
            rd, wr = os.pipe()
            os.dup2(wr, 2)
            os.close(wr)
        except OSError:
            return  # no usable stderr (daemonized); nothing to filter

        def pump() -> None:
            buf = b""
            while True:
                try:
                    chunk = os.read(rd, 65536)
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                out = []
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line, buf = buf[: nl + 1], buf[nl + 1 :]
                    if not any(p in line for p in NATIVE_SPAM_PATTERNS):
                        out.append(line)
                if buf and not _might_be_spam_prefix(buf):
                    out.append(buf)
                    buf = b""
                if out:
                    try:
                        os.write(real, b"".join(out))
                    except OSError:
                        break
            if buf and not any(p in buf for p in NATIVE_SPAM_PATTERNS):
                try:
                    os.write(real, buf)
                except OSError:
                    pass
            try:
                os.close(rd)
            except OSError:
                pass

        t = threading.Thread(target=pump, daemon=True, name="stderr-filter")
        t.start()
        _FILTER_STATE = {"real": real, "thread": t}
        atexit.register(uninstall_native_log_filter)


def uninstall_native_log_filter() -> None:
    """Restore the real stderr on fd 2 and drain the pump (atexit; safe
    to call directly — tests do)."""
    global _FILTER_STATE, _STDERR_WAS_TTY
    with _LOCK:
        state, _FILTER_STATE = _FILTER_STATE, None
        _STDERR_WAS_TTY = None
    if state is None:
        return
    import os

    try:
        sys.stderr.flush()
    except Exception:
        pass
    # restoring fd 2 closes the pipe's only write end → pump sees EOF,
    # drains, and exits; the pump writes through state["real"], so it must
    # stay open until the join completes
    try:
        os.dup2(state["real"], 2)
    except OSError:
        pass
    state["thread"].join(timeout=2.0)
    try:
        os.close(state["real"])
    except OSError:
        pass


def set_quiet(quiet: bool) -> None:
    global _QUIET
    with _LOCK:
        _QUIET = quiet


def is_quiet() -> bool:
    return _QUIET


def info_print(*args: object) -> None:
    """Informational message → stderr, suppressed in quiet mode."""
    if not _QUIET:
        print(*args, file=sys.stderr)


def warn_print(*args: object) -> None:
    """Warning → stderr, suppressed in quiet mode."""
    if not _QUIET:
        print("warning:", *args, file=sys.stderr)


class ProgressLine:
    """Single-line progress display on stderr (the analog of the
    reference's indicatif bar, index/mod.rs:573-798): carriage-return
    updates on a tty, periodic plain lines otherwise, nothing in quiet
    mode. ``finish`` clears the line so the summary prints clean."""

    def __init__(self, total: int, label: str = "indexing"):
        self.total = total
        self.label = label
        self._tty = stderr_isatty()
        self._last_plain = 0.0

    def update(self, done: int, extra: str = "") -> None:
        if _QUIET or self.total <= 0:
            return
        import time as _t

        pct = 100.0 * done / self.total
        msg = f"{self.label}: {done}/{self.total} files ({pct:.0f}%){extra}"
        if self._tty:
            sys.stderr.write("\r\x1b[2K" + msg)
            sys.stderr.flush()
        else:
            now = _t.monotonic()
            if now - self._last_plain >= 5.0 or done == self.total:
                self._last_plain = now
                print(msg, file=sys.stderr)

    def finish(self) -> None:
        if not _QUIET and self._tty:
            sys.stderr.write("\r\x1b[2K")
            sys.stderr.flush()


def error_print(*args: object) -> None:
    """Errors always go to stderr, even in quiet mode."""
    print("error:", *args, file=sys.stderr)


def result_print(s: str) -> None:
    """Results go to stdout — the only sanctioned stdout writer."""
    sys.stdout.write(s)
    if not s.endswith("\n"):
        sys.stdout.write("\n")
    sys.stdout.flush()
