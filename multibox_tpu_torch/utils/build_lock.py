"""An exclusive lock beside a build directory, across processes.

The CUDA kernels (``ops.kernels``) and the native libraries
(``data._native``) are built at first use. Several processes may start at
once (test workers, the ranks of a data-parallel run); under this lock one
builds and the others, waiting, find its output and load it.
"""

from __future__ import annotations

import contextlib
import fcntl
import os


@contextlib.contextmanager
def build_lock(directory: str):
    """Hold an exclusive ``fcntl`` lock on ``<directory>.lock`` (a file
    beside the build directory, made if missing) for the block, and make
    the directory: one process of many builds at a time. The kernel drops
    the lock when its holder dies, so none goes stale."""
    directory = os.path.abspath(directory)
    os.makedirs(os.path.dirname(directory), exist_ok=True)
    with open(directory + ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        os.makedirs(directory, exist_ok=True)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
