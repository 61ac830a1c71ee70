"""Filesystem utilities: TmpDir, durable writes, lockfile.

Reference: src/util/{Fs,TmpDir}.{h,cpp} — mkpath, durableRename,
lockFile/unlockFile (single-process-per-DB guard), TmpDirManager's
per-activity scratch dirs cleaned on close.

The copy of stellar_core_tpu/util/fs.py.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

from . import logging as slog

log = slog.get("Fs")


def mkpath(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def durable_write(path: str, data: bytes) -> None:
    """Atomic + power-loss-durable file write: tmp, fsync, rename, fsync
    dir (reference: Fs::durableRename discipline)."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def lock_file(path: str) -> int:
    """Take an exclusive advisory lock (reference: Fs::lockFile guards one
    process per database).  Returns the fd; raises if already locked."""
    import fcntl
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(fd)
        raise RuntimeError(f"{path} is locked by another process")
    os.write(fd, str(os.getpid()).encode())
    return fd


def unlock_file(fd: int) -> None:
    import fcntl
    fcntl.flock(fd, fcntl.LOCK_UN)
    os.close(fd)


class TmpDir:
    """Scoped scratch directory (reference: TmpDir via TmpDirManager)."""

    def __init__(self, base: Optional[str] = None, prefix: str = "work"):
        self.path = tempfile.mkdtemp(prefix=f"{prefix}-", dir=base)

    def __enter__(self) -> "TmpDir":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def cleanup(self) -> None:
        if os.path.isdir(self.path):
            shutil.rmtree(self.path, ignore_errors=True)
