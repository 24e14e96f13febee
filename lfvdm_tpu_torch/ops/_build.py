"""Build the CUDA kernels under ``ops/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a shared
library with a plain C interface (no PyTorch headers, so ``nvcc`` takes
seconds). The hash covers every file in ``csrc``, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built at import
time: the first launch of a kernel builds it, and ``build()`` builds them
all at once, one ``nvcc`` process per source, in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
KERNELS = ("temporal_rpe_attention", "spatial_attention", "skip_conv_stats")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_funcs: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, else $PATH, else /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_sources_digest()}.so"


def build(names: Optional[Iterable[str]] = None, *, force: bool = False) -> Dict[str, float]:
    """Compile the named kernels (default: all) in parallel.

    Returns seconds per kernel compiled (0.0 for one already built). The
    compiler's register/shared-memory report goes to ``_build/<name>.log``.
    Raises with the compiler's output when a build fails.
    """
    names = tuple(names or KERNELS)
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name``, built on first use."""
    fn = _funcs.get(symbol)
    if fn is not None:
        return fn
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _funcs[symbol] = fn
    return fn
