"""ctypes binding of the native C++ video batch loader (counterpart of
lfvdm_tpu/data/native_loader.py).

``native/videoloader.cpp`` (the port's own copy of the JAX package's source)
serves (B, T, H, W, C) batches of frame windows from one-file-per-video
``.npy`` datasets with a worker pool and partial reads: only the window's
byte range is read from disk. The library is built with ``g++`` at first
use into ``native/_build/libvideoloader-<hash>.so``, the hash covering the
source, so an edited source is rebuilt and a stale library never loaded.
``LFVDM_NATIVE_LOADER=0`` disables it; the Python loader of
``data/datasets.py`` is the fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "videoloader.cpp"
BUILD_DIR = _NATIVE_DIR / "_build"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libvideoloader-{digest}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the shared library to ``out``; returns an error string or None.
    The compiler writes a file of its own and it is renamed into place, so
    processes building at once never load a partial library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(_SRC),
           "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:  # no g++, or a hang
        return f"native loader build failed: {e}"
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"native loader build failed:\n{res.stderr[-2000:]}"
    os.replace(tmp, out)
    return None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if os.environ.get("LFVDM_NATIVE_LOADER", "1") == "0":
            _build_error = "disabled via LFVDM_NATIVE_LOADER=0"
            return None
        path = library_path()
        if not path.exists():
            err = _build(path)
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(str(path))
        lib.vl_open.restype = ctypes.c_void_p
        lib.vl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
                                ctypes.c_int]
        lib.vl_item_info.restype = ctypes.c_int
        lib.vl_item_info.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
        lib.vl_batch_bytes.restype = ctypes.c_int64
        lib.vl_batch_bytes.argtypes = [ctypes.c_void_p]
        lib.vl_next.restype = ctypes.c_int
        lib.vl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.vl_close.restype = None
        lib.vl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_loader_available() -> bool:
    return _load_lib() is not None


def native_loader_error() -> Optional[str]:
    _load_lib()
    return _build_error


class NativeVideoLoader:
    """Infinite (B, T, H, W, C) batch source backed by the C++ loader.

    ``paths``: per-video .npy files, frame-major, uint8 or float32, all with
    the same per-frame shape and dtype. ``deterministic`` disables the epoch
    shuffle (window starts stay random, as in the Python path);
    ``test_mode`` also pins every window start to 0 (a test split's
    semantics).
    """

    def __init__(self, paths: List[str], T: int, batch_size: int, *,
                 num_threads: int = 4, capacity: int = 4, seed: int = 0,
                 deterministic: bool = False, test_mode: bool = False):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(_build_error or "native loader unavailable")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.vl_open(arr, len(paths), T, batch_size, num_threads,
                                   capacity, seed, int(deterministic), int(test_mode))
        if not self._handle:
            raise RuntimeError(
                "vl_open failed (unreadable/mixed-shape/mixed-dtype/too-short "
                f".npy files, T={T} longer than a video, or batch_size > "
                "number of videos)")
        shape = (ctypes.c_int64 * 16)()
        ndim = ctypes.c_int()
        dtype = ctypes.c_int()
        lib.vl_item_info(self._handle, shape, ctypes.byref(ndim), ctypes.byref(dtype))
        self.item_shape = tuple(shape[i] for i in range(ndim.value))
        self.dtype = np.uint8 if dtype.value == 0 else np.float32
        self.batch_size = batch_size
        self._batch_bytes = lib.vl_batch_bytes(self._handle)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.batch_size,) + self.item_shape, self.dtype)
        rc = self._lib.vl_next(self._handle, out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
        if rc == -3:
            raise RuntimeError("native loader: a video file failed to read mid-stream "
                               "(deleted/truncated/shape-changed?)")
        if rc != 0:
            raise RuntimeError(f"vl_next failed: {rc}")
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vl_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
