#!/usr/bin/env python3
"""Time variants of the skip-projection kernel against each other on one card.

    python3 tools/skipconv_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...] [--iters 50]

Each CSRC_DIR holds a ``skip_conv_stats.cu`` (and the ``common.cuh`` it
includes): the port's own ``lfvdm_tpu_torch/ops/csrc``, or a copy of another
version unpacked into a directory that ``.gitignore`` lists (``_archive/``),
e.g. the parent commit's with ``git archive <commit> lfvdm_tpu_torch/ops/csrc``.
Every variant is built with the port's ``nvcc`` flags to its own library (one
``nvcc`` per variant, in parallel) and loaded with ctypes. A library that
exports ``lfvdm_skip_conv_stats_plan`` is called with its own plan; an older
one takes its pixel-tile count ceil(P / 64) instead.

At each distinct flagship up-path shape (``chip_smoke.SKIP_SHAPES``, bf16,
N = B·K = 40) every variant is first held against the plain version (the
limits of ``chip_smoke.py``), then all are timed in turns, forwards and then
backwards (A, B, B, A for two), each reading the mean device time of 50
launches queued behind a spin kernel (``chip_smoke.cuda_ms(queued=True)``);
``baddbmm`` (y without the bias and the statistics) is timed in the same
turns. Prints one JSON line per shape and a summary per flagship forward (the
10 launches), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from lfvdm_tpu_torch.ops import _build, skipconv  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(variants, out_dir):
    """{name: csrc dir} -> {name: ctypes library}, one nvcc per variant in parallel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in variants.items():
        lib = out_dir / f"libskip_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / "skip_conv_stats.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib, time.perf_counter())
    libs = {}
    for name, (proc, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        chip_smoke.emit({"phase": "build", "variant": name, "rc": proc.returncode,
                         "s": time.perf_counter() - t0, "ptxas": ptxas})
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def caller(lib, N, c1, c2, F, P, sms):
    """A function running one launch of this library's kernel on (x1, x2, w, b, resid)."""
    import torch

    fn = lib.lfvdm_skip_conv_stats
    has_plan = hasattr(lib, "lfvdm_skip_conv_stats_plan")
    if has_plan:
        plan_fn = lib.lfvdm_skip_conv_stats_plan
        plan_fn.argtypes = [_I] * 8 + [_P]
        plan = (ctypes.c_int * 8)()
        if plan_fn(1, N, c1, c2, F, P, 1, sms, plan) != 0:
            raise RuntimeError("plan refused")
        p_tiles, last = plan[5], plan
        fn.argtypes = [_I] + [_P] * 9 + [_I] * 5 + [_P, _P]
    else:
        p_tiles = -(-P // 64)
        last = p_tiles
        fn.argtypes = [_I] + [_P] * 9 + [_I] * 6 + [_P]
    partial = torch.empty(2 * N * p_tiles * F, dtype=torch.float32, device="cuda")

    def run(x1, x2, w, b, resid):
        y = torch.empty_like(resid)
        s1 = torch.empty(N, F, dtype=torch.float32, device="cuda")
        s2 = torch.empty_like(s1)
        rc = fn(1, x1.data_ptr(), x2.data_ptr(), w.data_ptr(), b.data_ptr(), resid.data_ptr(),
                y.data_ptr(), partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), N, c1, c2, F, P,
                last, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return y, s1, s2

    return run, (list(plan) if has_plan else None)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=str(ROOT / "_archive" / "ab_build"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("skipconv_ab: no CUDA device is available", file=sys.stderr)
        return 1
    variants = dict(v.split("=", 1) for v in args.variants)
    variants = {k: Path(v).resolve() for k, v in variants.items()}
    chip_smoke.phase_device()
    libs = build(variants, Path(args.out))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    N = chip_smoke.FLAGSHIP_B * chip_smoke.FLAGSHIP_K
    rows = {}
    for shape in dict.fromkeys(chip_smoke.SKIP_SHAPES):
        _, c1, c2, F, S = shape
        P, K = S * S, c1 + c2

        def rnd(*shp, scale=1.0):
            return (torch.randn(shp, generator=gen, device="cuda") * scale).to(torch.bfloat16)

        inputs = (rnd(N, c1, P), rnd(N, c2, P), rnd(F, K, scale=K ** -0.5), rnd(F, scale=0.1),
                  rnd(N, F, P))
        xcat = torch.cat(inputs[:2], dim=1)
        wb, r3 = inputs[2].expand(N, F, K), inputs[4]
        with torch.no_grad():
            ref = skipconv.skip_conv_stats_plain(*inputs)
        limits = [r * t.float().abs().max().item() for r, t in zip((2e-2, 2e-3, 2e-3), ref)]
        runs, plans, errs = {}, {}, {}
        for name, lib in libs.items():
            runs[name], plans[name] = caller(lib, N, c1, c2, F, P, sms)
            out = runs[name](*inputs)
            torch.cuda.synchronize()
            errs[name] = [(a.float() - b.float()).abs().max().item() for a, b in zip(out, ref)]
            for _ in range(2):  # repeated launches are bitwise equal
                again = runs[name](*inputs)
                if not all(torch.equal(a, b) for a, b in zip(out, again)):
                    raise RuntimeError(f"{name} {shape}: repeated launches differ")
            if not all(e <= lim for e, lim in zip(errs[name], limits)):
                raise RuntimeError(f"{name} {shape}: errors {errs[name]} over {limits}")
        timed = {name: (lambda r=run: r(*inputs)) for name, run in runs.items()}
        timed["baddbmm"] = lambda: torch.baddbmm(r3, wb, xcat)
        order = list(timed)
        ms = {name: [] for name in order}
        for name in order + order[::-1]:
            ms[name].append(chip_smoke.cuda_ms(timed[name], args.iters, queued=True))
        nbytes = (N * (c1 + c2 + 2 * F) * P + F * K + F) * 2 + 2 * N * F * 4
        b_ms, b_by = chip_smoke.bound(nbytes, 2 * N * P * K * F, "bfloat16")
        row = {"phase": "ab", "shape": list(shape), "N": N, "bound_ms": b_ms, "bound_by": b_by,
               "ms": {k: sum(v) / len(v) for k, v in ms.items()}, "readings": ms,
               "max_abs_err": errs, "limit_abs": limits, "plans": plans}
        chip_smoke.emit(row)
        rows[shape] = row
    per_forward = {name: sum(rows[s]["ms"][name] for s in chip_smoke.SKIP_SHAPES)
                   for name in order}
    chip_smoke.emit({"phase": "ab_summary", "unit": "one flagship forward: 10 launches",
                     "ms": per_forward,
                     "bound_ms": sum(rows[s]["bound_ms"] for s in chip_smoke.SKIP_SHAPES)})
    return 0 if all(math.isfinite(v) for v in per_forward.values()) else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
