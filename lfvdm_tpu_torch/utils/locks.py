"""A file lock for jobs that share files (counterpart of
lfvdm_tpu/utils/locks.py, POSIX ``fcntl`` form): it guards the
copy-on-first-read dataset cache against concurrent jobs."""

from __future__ import annotations

import fcntl
import os


class Protect:
    """Exclusive access to ``file_path`` through a sibling ``.lock`` file
    (usable before the protected file exists)."""

    def __init__(self, file_path):
        self._path = f"{file_path}.lock"
        os.makedirs(os.path.dirname(os.path.abspath(self._path)), exist_ok=True)
        self._fd = None

    def __enter__(self):
        self._fd = open(self._path, "w")
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._fd, fcntl.LOCK_UN)
        self._fd.close()
        return False
