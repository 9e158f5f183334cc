"""Filesystem seam for warehouse, report and stream IO: the local subset of
nds_tpu/io/fs.py.

Every open is a fault-injection point (faults.maybe_fire_path), and
`fs_open_atomic` writes through a temp name + rename, so that a crash
mid-write never leaves a torn report or time log behind. The reference
routes `scheme://` paths through fsspec with retried opens; the port
refuses them (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import os
import uuid

from .. import faults

#: transient-IO retry budget of the report ladder's io_backoff_retry rung
IO_RETRIES_ENV = "NDS_IO_RETRIES"
IO_BACKOFF_ENV = "NDS_IO_BACKOFF"


def io_retry_budget():
    """(retries, backoff_base_seconds) for transient IO failures."""
    return (
        int(os.environ.get(IO_RETRIES_ENV, "3")),
        float(os.environ.get(IO_BACKOFF_ENV, "0.5")),
    )


def is_remote(path) -> bool:
    """True for scheme-qualified paths (file:// included)."""
    return "://" in str(path)


def local_path(path) -> str:
    """`path` as a string; a remote path raises."""
    if is_remote(path):
        raise NotImplementedError(
            f"remote path {path!r}: fsspec paths are not ported to "
            f"nds_tpu_torch yet: ROADMAP.md queue 1 item 9 (harness entry "
            f"points)"
        )
    return str(path)


def fs_open(path, mode: str = "r", newline=None, encoding=None):
    """open() for local paths, firing the path's fault site first (the
    caller closes). A write makes the parent directory."""
    path = local_path(path)
    faults.maybe_fire_path(path)
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    return open(path, mode, newline=newline, encoding=encoding)


class _AtomicFile:
    """File-like wrapper that writes to a temp sibling and renames it into
    place on a clean close; a close after an error leaves the destination
    untouched, so readers see the old complete file or the new one."""

    def __init__(self, path, mode, newline=None, encoding=None):
        self._dest = local_path(path)
        parent = os.path.dirname(self._dest)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._tmp = f"{self._dest}.tmp-{uuid.uuid4().hex[:8]}"
        faults.maybe_fire_path(self._dest)
        self._fh = open(self._tmp, mode, newline=newline, encoding=encoding)
        self._committed = False

    def __getattr__(self, name):
        return getattr(self._fh, name)

    def __iter__(self):
        return iter(self._fh)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(commit=exc_type is None)
        return False

    def close(self, commit: bool = True):
        if self._committed:
            return
        self._fh.close()
        self._committed = True
        if commit:
            os.replace(self._tmp, self._dest)
            return
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


def fs_open_atomic(path, mode: str = "w", newline=None, encoding=None):
    """Crash-safe fs_open for whole-file writes (reports, time logs): the
    content lands under a temp name and renames into place on close. Use
    as a context manager; an exception inside the block discards the temp
    file instead of publishing it."""
    if "w" not in mode:
        raise ValueError(f"fs_open_atomic is write-only, got mode {mode!r}")
    return _AtomicFile(path, mode, newline=newline, encoding=encoding)


def join(base, *parts) -> str:
    """Path join (local paths only)."""
    return os.path.join(local_path(base), *parts)
