"""Filesystem seam for warehouse, report and stream IO: the port of
nds_tpu/io/fs.py.

A `scheme://` path (memory:// in tests, s3:// or gs:// in deployments) is
handled by the matching fsspec filesystem; plain paths stay on the local
POSIX calls. fsspec is imported only where a scheme-qualified path is
resolved (`get_fs`): a local path gets `LocalFS`, the subset of fsspec's
local filesystem that the lakehouse and the Load Test call, so the port's
local paths need no fsspec at all.

Remote opens retry transient errors with exponential backoff and full
jitter (NDS_IO_RETRIES / NDS_IO_BACKOFF); `fs_open_atomic` writes through
a temp name + rename, so that a crash mid-write never leaves a torn report
or time log behind; every open is a fault-injection point
(faults.maybe_fire_path). A retry emits an `io_retry` event into the
thread-bound tracer.
"""

from __future__ import annotations

import os
import posixpath
import shutil
import time
import uuid

from .. import faults

#: transient-IO retry budget of remote opens and of the report ladder's
#: io_backoff_retry rung (attempts = retries + 1)
IO_RETRIES_ENV = "NDS_IO_RETRIES"
IO_BACKOFF_ENV = "NDS_IO_BACKOFF"


def io_retry_budget():
    """(retries, backoff_base_seconds) for transient IO failures."""
    return (
        int(os.environ.get(IO_RETRIES_ENV, "3")),
        float(os.environ.get(IO_BACKOFF_ENV, "0.5")),
    )


def is_remote(path) -> bool:
    """True for scheme-qualified paths (file:// included: it routes through
    get_fs for scheme stripping, since os calls on the literal URL would
    make a relative './file:/...' directory)."""
    return "://" in str(path)


class LocalFS:
    """The calls of fsspec's LocalFileSystem that the port makes, on local
    POSIX paths: `ls` returns full paths (or fsspec's detail dicts), `mv`
    is an atomic rename, `open` makes no parent directory."""

    protocol = ("file", "local")

    def ls(self, path, detail=False):
        names = sorted(os.listdir(path))
        full = [posixpath.join(path, n) for n in names]
        if not detail:
            return full
        return [self.info(p) for p in full]

    def info(self, path):
        st = os.stat(path)
        kind = "directory" if os.path.isdir(path) else "file"
        return {"name": path, "size": st.st_size, "type": kind}

    def exists(self, path):
        return os.path.exists(path)

    def isdir(self, path):
        return os.path.isdir(path)

    def makedirs(self, path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)

    def open(self, path, mode="rb"):
        return open(path, mode)

    def rm_file(self, path):
        os.remove(path)

    def rm(self, path, recursive=False):
        if recursive and os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)

    def mv(self, src, dst):
        os.replace(src, dst)


_LOCAL = LocalFS()


def get_fs(path):
    """(filesystem, normalized path) for any local path or URL: LocalFS and
    the absolute path for a local one, fsspec's filesystem for a URL."""
    if not is_remote(path):
        return _LOCAL, os.path.abspath(os.path.expanduser(str(path)))
    import fsspec

    fs, _, paths = fsspec.get_fs_token_paths(str(path))
    return fs, paths[0]


def arrow_filesystem(fs):
    """The `filesystem=` argument of a pyarrow dataset over `fs`'s paths:
    None for local paths (pyarrow's own), else the fsspec filesystem."""
    return None if isinstance(fs, LocalFS) else fs


def _open_remote_with_retries(path, mode):
    """Open a remote path, retrying transient failures with exponential
    backoff + full jitter. Deterministic errors raise immediately."""
    retries, base = io_retry_budget()
    delays = faults.backoff_delays(retries, base)
    while True:
        try:
            faults.maybe_fire_path(path)
            fs, p = get_fs(path)
            if "w" in mode or "a" in mode:
                parent = posixpath.dirname(p)
                if parent:
                    fs.makedirs(parent, exist_ok=True)
            return fs.open(p, mode)
        except Exception as exc:
            if faults.classify(exc) != faults.IO_TRANSIENT:
                raise
            delay = next(delays, None)
            if delay is None:
                raise
            print(
                f"fs: transient io failure opening {path} ({exc}); "
                f"retrying in {delay:.2f}s"
            )
            # observability: the retry in the bound stream's event log
            # (lazy import, on the already-slow retry path only)
            from ..obs import trace as _obs_trace

            tracer = _obs_trace.current()
            if tracer is not None:
                tracer.emit(
                    "io_retry", path=str(path), error=str(exc)[:200],
                    delay_s=round(delay, 3),
                )
            time.sleep(delay)


def fs_open(path, mode: str = "r", newline=None, encoding=None):
    """open() for local paths and URLs alike, firing the path's fault site
    first (the caller closes). A write makes the parent directory.
    `newline` and `encoding` apply to local text mode."""
    if is_remote(path):
        return _open_remote_with_retries(path, mode)
    path = str(path)
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
        self._dest = str(path)
        self._remote = is_remote(path)
        self._tmp = f"{self._dest}.tmp-{uuid.uuid4().hex[:8]}"
        if self._remote:
            self._fh = fs_open(self._tmp, mode)
        else:
            parent = os.path.dirname(self._dest)
            if parent:
                os.makedirs(parent, exist_ok=True)
            faults.maybe_fire_path(self._dest)
            self._fh = open(self._tmp, mode, newline=newline,
                            encoding=encoding)
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
        if not self._remote:
            if commit:
                os.replace(self._tmp, self._dest)
                return
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            return
        fs, tmp = get_fs(self._tmp)
        if commit:
            fs.mv(tmp, get_fs(self._dest)[1])
            return
        try:
            fs.rm_file(tmp)
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
    """Path join that keeps URL schemes intact."""
    if is_remote(base):
        return posixpath.join(str(base), *parts)
    return os.path.join(str(base), *parts)


def put_if_absent(fs, tmp: str, dest: str) -> bool:
    """Move tmp to dest only if dest does not exist; True on success.

    Local filesystems get an atomic os.link (two concurrent committers
    cannot both win). Remote stores without an atomic create-exclusive
    primitive fall back to exists + move, the best-effort window a catalog
    service closes; single-writer benchmark phases never race it."""
    proto = fs.protocol if isinstance(fs.protocol, str) else fs.protocol[0]
    if proto in ("file", "local"):
        try:
            os.link(tmp, dest)
        except FileExistsError:
            os.unlink(tmp)
            return False
        os.unlink(tmp)
        return True
    if fs.exists(dest):
        fs.rm_file(tmp)
        return False
    fs.mv(tmp, dest)
    return True
