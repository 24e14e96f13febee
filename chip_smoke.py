#!/usr/bin/env python3
"""Drive the PyTorch port (lfvdm_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises (non-zero exit):
  1. device  — the card's name and power limit (nvidia-smi); a card is required.
  2. build   — compiles every CUDA kernel from ops/csrc (one nvcc per source,
               in parallel) and times the build.
  3. kernels — each attention kernel against its plain PyTorch version at both
               flagship shapes (ds 8 and ds 16), in f32 (TF32 off) and bf16,
               with the spatial kernel's route (bf16: "mma", f32: "fma");
               the skip projection (skip_conv_stats) at every distinct flagship
               up-path shape in bf16 (route "bulk") and at ds 1 and ds 16 in
               f32 (route "generic"), with its launch plan: errors, and
               CUDA-event device times (launches queued behind a spin kernel)
               of the kernel, the plain version, one PyTorch library call
               where one exists (a yardstick only: SDPA on the 4-D view
               (B·T, H, D, F) pinned to its flash backend in bf16 and its
               memory-efficient backend in f32 for spatial attention, baddbmm
               for the skip projection's y without its bias and statistics)
               and the least time the card could take (for temporal
               attention also its operations at the f32 CUDA-core rate);
               then one edge shape per kernel fault repaired, in f32 and
               bf16: temporal attention over 40 frames, spatial attention
               with 192-wide heads (FMA route).
  4. unet    — the flagship U-Net (128 px, B=2, K=20, bf16, random non-zero
               weights) on the kernel path against the plain path (and the
               same weights in f32), and with the fused skip projection against
               the unfused form (bf16 and f32), timed both ways; 7 + 7 + 10
               launches per forward, every spatial launch on the "mma" route
               and every skip projection on the "bulk" route;
               then a torch.profiler breakdown of one forward's device time.
  5. sample  — the sampling path: VideoSampler.sample_video over a 40-frame
               video (autoreg, 3 windows of K=20, ancestral, 50 steps), then one
               DDIM (ddim25) and one DPM-Solver++ (dpm20) window. Launch counts
               are reset just before and read just after; each must equal
               7 + 7 + 10 per model call, on the same routes.
  6. train   — the training path: TrainLoop on the flagship config (B=2, K=20,
               bf16) over the synthetic dataset at 128 px: warm-up steps, then
               timed steps (finite losses, parameters move, the EMA formula,
               7 + 7 + 10 launches per step), one step in two microbatches, one
               non-finite step that changes nothing, a checkpoint save and
               resume, and a profile of one step by kernel group.
  7. parity  — one train step's loss and gradients on the kernel path against
               impl="plain", in bf16 and in f32 (TF32 off).
  8. latent  — the latent path (config.latent_config(): 32x32 C4 SVD-VAE
               latents, 64 channels, B=1, K=5, bf16), whose kernel launches
               phase 3 already held against their plain versions at the latent
               shapes (attention F=32 with D=256, 64, 16 over T=5 frames; the 8
               up-path skip projections, 4x4 to 32x32 pixels):
               a. unet   — the latent U-Net forward, kernel vs plain (bf16 and
                           f32), fused vs unfused skip projection, 7 + 7 + 8
                           launches per forward on the routes the shape rules
                           (_spatial_route, skipconv.plan) give;
               b. sample — VideoSampler(codec=PreEncodedLatentCodec(vae=SVDVae))
                           samples a 20-frame latent video (autoreg, n_obs 2,
                           max_frames 5, step 2, ancestral, 50 steps) and decodes
                           it once through the full-width VAE (seeded random
                           weights) to (1, 20, 3, 256, 256); the observed latent
                           frames must be kept exactly;
               c. vae    — encode (mean) and decode of one 64 px frame, card vs
                           the machine's CPU in f32 (relative L2 <= 1e-2), at
                           PyTorch's TF32 defaults and with TF32 off;
               d. train  — TrainLoop on the latent config: 3 steps over an
                           EncodedNpyDataset of seeded latents (written to a
                           temporary directory and removed), then 2 steps with
                           VAECodec encoding 256 px frames online.
               The VAE phases run at PyTorch's default TF32 settings.
  9. the "kernels" summary line, then {"ok": true, "device": {...}} last.

Exits non-zero without printing a result when no CUDA device is present or
when the lfvdm_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,      # dense tensor-core bf16
              "float32": 67e12}        # f32 outside the tensor cores (TF32 off)
FLAGSHIP_B, FLAGSHIP_K = 2, 20
# Flagship attention shapes: (heads, tokens D, features F) at each ds, and the
# launches of each kernel per U-Net forward at that ds (down 1 + up 2 at ds 8;
# down 1 + middle 1 + up 2 at ds 16).
ATTN_SHAPES = {"ds8": dict(H=4, D=256, F=96, per_forward=3),
               "ds16": dict(H=4, D=64, F=128, per_forward=4)}
# Flagship up-path skip projections: (level, c1, c2, F, H = W) of the 10 up
# ResBlocks of one forward (M = B·K·H·W rows).
SKIP_SHAPES = [("ds16", 512, 512, 512, 8), ("ds16", 512, 384, 512, 8),
               ("ds8", 512, 384, 384, 16), ("ds8", 384, 256, 384, 16),
               ("ds4", 384, 256, 256, 32), ("ds4", 256, 128, 256, 32),
               ("ds2", 256, 128, 128, 64), ("ds2", 128, 128, 128, 64),
               ("ds1", 128, 128, 128, 128), ("ds1", 128, 128, 128, 128)]
SKIP_F32_SHAPES = [SKIP_SHAPES[0], SKIP_SHAPES[8]]  # ds 16 and ds 1
KERNEL_NAMES = ("temporal_rpe_attention", "spatial_attention", "skip_conv_stats")
PER_FORWARD = {"temporal_rpe_attention": 7, "spatial_attention": 7, "skip_conv_stats": 10}
# The spatial kernel's route by dtype (ops/attention.py _spatial_route at the
# flagship widths), and the SDPA backend its yardstick is pinned to.
SPATIAL_ROUTES = {"bfloat16": "mma", "float32": "fma"}
# The skip projection's route by dtype (ops/skipconv.py plan at the flagship
# widths); every launch of the main paths is bf16, so "bulk".
SKIP_ROUTES = {"bfloat16": "bulk", "float32": "generic"}
SDPA_BACKENDS = {"bfloat16": "FLASH_ATTENTION", "float32": "EFFICIENT_ATTENTION"}
REPLACES = {
    "temporal_rpe_attention": "lfvdm_tpu/ops/attention.py:210 (_temporal_pallas -> _temporal_kernel :143)",
    "spatial_attention": "lfvdm_tpu/ops/attention.py:106 (_spatial_pallas -> _spatial_kernel :81)",
    "skip_conv_stats": "lfvdm_tpu/ops/skipconv.py:88 (_fwd_pallas -> _kernel :65)",
}
# Kernels with more than one route, and the route every launch of the main
# paths must take.
ROUTED = {"spatial_attention": SPATIAL_ROUTES["bfloat16"],
          "skip_conv_stats": SKIP_ROUTES["bfloat16"]}
SOURCES = {"temporal_rpe_attention": "lfvdm_tpu_torch/ops/csrc/temporal_rpe_attention.cu",
           "spatial_attention": "lfvdm_tpu_torch/ops/csrc/spatial_attention.cu",
           "skip_conv_stats": "lfvdm_tpu_torch/ops/csrc/skip_conv_stats.cu"}
# The latent config's window (config.latent_config(), the reference's latent
# command), its attention shapes (tokens D at ds 2, 4 and the middle block's
# ds 8; 4 heads of 32 features) with launches per forward, and its 8 up-path
# skip projections (level, c1, c2, F, H = W; M = B·K·H·W rows).
LATENT_B, LATENT_K = 1, 5
LATENT_ATTN_SHAPES = {"ds2": dict(H=4, D=256, F=32, per_forward=3),
                      "ds4": dict(H=4, D=64, F=32, per_forward=3),
                      "ds8": dict(H=4, D=16, F=32, per_forward=1)}
LATENT_SKIP_SHAPES = [("ds8", 128, 128, 128, 4), ("ds8", 128, 128, 128, 4),
                      ("ds4", 128, 128, 128, 8), ("ds4", 128, 128, 128, 8),
                      ("ds2", 128, 128, 128, 16), ("ds2", 128, 64, 128, 16),
                      ("ds1", 128, 64, 64, 32), ("ds1", 64, 64, 64, 32)]
LATENT_PER_FORWARD = {"temporal_rpe_attention": 7, "spatial_attention": 7, "skip_conv_stats": 8}
LATENT_WINDOW = dict(B=LATENT_B, K=LATENT_K, n_obs=2, n_latent=3)  # window_inputs sizes
LATENT_RESPACING = "50"
LATENT_VIDEO_T = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


HOLD_CYCLES = 100_000_000  # ~50 ms of spinning at the H100's ~2 GHz SM clock


def cuda_ms(fn, iters: int, warmup: int = 3, queued: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events.

    ``queued``: the stream first runs a spin kernel (~50 ms) and the launches
    queue up behind it, so the events time the device's work alone. Without
    it, back-to-back calls whose host side is slower than their kernels (a
    ~10 µs kernel behind a Python wrapper) time the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Kernel-name groups for the device profiles, first match wins.
KERNEL_GROUPS = (
    ("port kernels", ("skip_conv_stats", "temporal_rpe_attention", "spatial_attention",
                      "reduce_partials")),
    ("optimizer and EMA (foreach)", ("multi_tensor", "foreach", "adam")),
    ("GroupNorm", ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
                   "computeinternalgradients", "gammabeta")),
    ("convolution", ("conv", "implicit", "dgrad", "wgrad", "fprop", "winograd")),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("GEMM", ("gemm", "cutlass", "xmma", "sm90", "cublas", "splitk")),
    ("concat and copies", ("cat", "copy")),
    ("elementwise and reductions", ("elementwise", "vectorized", "reduce", "unrolled")),
)


def device_kernels_ms(prof, per):
    """Device time by kernel name from a torch.profiler run, per unit of work.
    User-annotation ranges on the device timeline (an optimizer step's span,
    say) are left out: they would count their kernels twice."""
    from torch.autograd import DeviceType

    per_kernel = {}
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3 / per
        if (e.device_type == DeviceType.CUDA and ms > 0
                and not getattr(e, "is_user_annotation", False)):
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + ms
    return per_kernel


def group_ms(per_kernel):
    groups = {}
    for name, ms in per_kernel.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


# ---------------------------------------------------------------------------
# Phase 1-2: device and build
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


def phase_build():
    from lfvdm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_kernel = _build.build(force=True)
    wall = time.perf_counter() - t0
    ptxas = {}
    for name in _build.KERNELS:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "wall_s": wall, "per_kernel_s": per_kernel, "ptxas": ptxas})


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def temporal_inputs(H, D, F, dtype, gen, B=FLAGSHIP_B, T=FLAGSHIP_K):
    """Kernel-layout inputs; the mask's last 2 frames are padding (mask 0),
    so both groups of the two-group softmax occur."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    q = rnd(B, H, T, F, D, scale=F ** -0.5)
    k, v = rnd(B, H, T, F, D), rnd(B, H, T, F, D)
    r_k, r_q_t = rnd(B, H, T, T, F, scale=0.1), rnd(B, H, T, T, F, scale=0.1 * F ** -0.5)
    r_v_t = rnd(B, H, T, F, T, scale=0.1)
    mask = torch.ones(B, T, device="cuda")
    mask[:, -2:] = 0.0
    return q, k, v, r_k, r_q_t, r_v_t, mask


def spatial_inputs(H, D, F, dtype, gen, B=FLAGSHIP_B, T=FLAGSHIP_K):
    import torch

    def rnd(scale=1.0):
        return (torch.randn((B, T, H, D, F), generator=gen, device="cuda") * scale).to(dtype)

    return rnd(F ** -0.5), rnd(), rnd()


def temporal_work(H, D, F, esize, B=FLAGSHIP_B, T=FLAGSHIP_K):
    """(bytes, flops): q, k, v, out and the three r tables once, the mask;
    five contractions over (t, s, f, d)."""
    nbytes = (4 * B * H * T * F * D + 3 * B * H * T * T * F) * esize + B * T * 4
    return nbytes, 10 * B * H * T * T * F * D


def spatial_work(H, D, F, esize, B=FLAGSHIP_B, T=FLAGSHIP_K):
    """(bytes, flops): q, k, v, out once; q kᵀ and attn v."""
    n = B * T * H
    return 4 * n * D * F * esize, 4 * n * D * D * F


def phase_kernels():
    """Both attention kernels at the flagship and the latent shapes (f32 and
    bf16), the skip projection at every distinct up-path shape of both
    configs, and the edge shapes."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for ds, shp in ATTN_SHAPES.items():
            for row in _attention_cases(ds, shp, dtype, gen):
                results[(row["name"], ds, row["dtype"])] = row
        for ds, shp in LATENT_ATTN_SHAPES.items():
            for row in _attention_cases(ds, shp, dtype, gen, B=LATENT_B, T=LATENT_K,
                                        path="latent"):
                results[("latent", row["name"], ds, row["dtype"])] = row
    for dtype, shapes in ((torch.bfloat16, SKIP_SHAPES), (torch.float32, SKIP_F32_SHAPES)):
        for shape in dict.fromkeys(shapes):  # distinct shapes, in order
            results[("skip_conv_stats",) + shape + (str(dtype).split(".")[-1],)] = \
                _skip_conv_case(dtype, shape, gen)
    for shape in dict.fromkeys(LATENT_SKIP_SHAPES):
        results[("latent", "skip_conv_stats") + shape + ("bfloat16",)] = _skip_conv_case(
            torch.bfloat16, shape, gen, B=LATENT_B, T=LATENT_K, path="latent")
    _edge_cases(gen)
    return results


def _attention_cases(ds, shp, dtype, gen, B=FLAGSHIP_B, T=FLAGSHIP_K, path="flagship"):
    """Temporal and spatial attention at one shape against their plain
    versions: errors, device times of the kernel, the plain version and the
    library yardstick, and the bound; the spatial route must be the one
    ``_spatial_route`` gives for the shape."""
    import torch
    import torch.nn.functional as Fn

    from lfvdm_tpu_torch.ops import attention as ops

    dname = str(dtype).split(".")[-1]
    esize = torch.finfo(dtype).bits // 8
    H, D, F = shp["H"], shp["D"], shp["F"]
    cases = {
        "temporal_rpe_attention": (
            temporal_inputs(H, D, F, dtype, gen, B=B, T=T), ops.temporal_rpe_attention,
            ops.temporal_rpe_attention_plain, None, temporal_work(H, D, F, esize, B=B, T=T)),
        "spatial_attention": (
            spatial_inputs(H, D, F, dtype, gen, B=B, T=T), ops.spatial_attention,
            ops.spatial_attention_plain, _sdpa(Fn, SDPA_BACKENDS[dname]),
            spatial_work(H, D, F, esize, B=B, T=T)),
    }
    rows = []
    for name, (args, kernel, plain, library, (nbytes, flops)) in cases.items():
        with torch.no_grad():
            routes = dict(ops.spatial_attention.launches_by_route)
            out = kernel(*args)
            route = next((r for r, n in ops.spatial_attention.launches_by_route.items()
                          if n != routes[r]), None)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not torch.isfinite(out.float()).all():
                raise RuntimeError(f"{name} {path} {ds} {dname}: non-finite output")
            ms = cuda_ms(lambda: kernel(*args), 50, queued=True)
            unqueued_ms = cuda_ms(lambda: kernel(*args), 50)
            plain_ms = cuda_ms(lambda: plain(*args), 20, queued=True)
            lib_ms = cuda_ms(lambda: library(*args), 50, queued=True) if library else None
        b_ms, b_by = bound(nbytes, flops, dname)
        limit = 1e-4 if dtype == torch.float32 else 2e-2 * scale
        row = {"phase": "kernel", "path": path, "name": name, "ds": ds, "dtype": dname,
               "shape": list(args[0].shape), "max_abs_err": err, "max_abs_ref": scale,
               "rel_err": err / scale, "limit_abs": limit, "ms": ms,
               "unqueued_ms": unqueued_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}
        if name == "spatial_attention":
            want = ops._spatial_route(dtype, D, F, args + (out,))
            row["route"], row["rule_route"] = route, want
            row["library"] = f"sdpa {SDPA_BACKENDS[dname]} on (B·T, H, D, F)"
        else:  # the least time of the same operations on the CUDA cores
            row["fma_floor_ms"] = flops / PEAK_FLOPS["float32"] * 1e3
        emit(row)
        if not err <= limit:
            raise RuntimeError(f"{name} {path} {ds} {dname}: max abs err {err} > {limit}")
        if name == "spatial_attention" and route != want:
            raise RuntimeError(f"spatial {path} {ds} {dname} took route {route}, "
                               f"the rule gives {want}")
        if path == "flagship" and name == "spatial_attention" and route != SPATIAL_ROUTES[dname]:
            raise RuntimeError(f"spatial {ds} {dname} took route {route}, "
                               f"expected {SPATIAL_ROUTES[dname]}")
        rows.append(row)
    return rows


def _edge_cases(gen):
    """One shape past each kernel's old limit, held against the plain version
    in both dtypes: temporal attention over 40 frames (two key chunks) and
    spatial attention with 192-wide heads (the FMA route in two feature
    chunks). Each must launch its kernel once."""
    import torch

    from lfvdm_tpu_torch.ops import attention as ops

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        cases = (("temporal_rpe_attention", "T=40",
                  temporal_inputs(4, 256, 96, dtype, gen, T=40), ops.temporal_rpe_attention,
                  ops.temporal_rpe_attention_plain),
                 ("spatial_attention", "F=192", spatial_inputs(2, 256, 192, dtype, gen),
                  ops.spatial_attention, ops.spatial_attention_plain))
        for name, edge, args, kernel, plain in cases:
            with torch.no_grad():
                before = ops.launch_counts()[name]
                routes = dict(ops.spatial_attention.launches_by_route)
                out = kernel(*args)
                launched = ops.launch_counts()[name] - before
                fma = ops.spatial_attention.launches_by_route["fma"] - routes["fma"]
                ref = plain(*args)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                ms = cuda_ms(lambda: kernel(*args), 10, queued=True)
            limit = 1e-4 if dtype == torch.float32 else 2e-2 * scale
            emit({"phase": "kernel_edge", "name": name, "edge": edge, "dtype": dname,
                  "shape": list(args[0].shape), "launches": launched, "max_abs_err": err,
                  "max_abs_ref": scale, "limit_abs": limit, "ms": ms})
            if launched != 1 or (name == "spatial_attention" and fma != 1):
                raise RuntimeError(f"{name} {edge} {dname}: {launched} launches (fma {fma})")
            if not (torch.isfinite(out.float()).all() and err <= limit):
                raise RuntimeError(f"{name} {edge} {dname}: max abs err {err} > {limit}")


def _skip_conv_case(dtype, shape, gen, B=FLAGSHIP_B, T=FLAGSHIP_K, path="flagship"):
    """skip_conv_stats at one up-path shape against its plain version: y, s1
    and s2 errors; times of the kernel, the plain version and a baddbmm of
    resid + W·[x1 ‖ x2] (y without the bias and the statistics)."""
    import torch

    from lfvdm_tpu_torch.ops import skipconv

    level, c1, c2, F, S = shape
    N, P, K = B * T, S * S, c1 + c2
    dname = str(dtype).split(".")[-1]
    esize = torch.finfo(dtype).bits // 8

    def rnd(*shp, scale=1.0):
        return (torch.randn(shp, generator=gen, device="cuda") * scale).to(dtype)

    x1, x2, w = rnd(N, c1, S, S), rnd(N, c2, S, S), rnd(F, K, scale=K ** -0.5)
    b, resid = rnd(F, scale=0.1), rnd(N, F, S, S)
    args = (x1, x2, w, b, resid)
    xcat = torch.cat([x1, x2], dim=1).reshape(N, K, P)
    wb = w.expand(N, F, K)
    r3 = resid.reshape(N, F, P)
    plan = skipconv.plan(N, c1, c2, F, P, dtype, sms=skipconv._sm_count(0))
    with torch.no_grad():
        routes = dict(skipconv.skip_conv_stats.launches_by_route)
        y, s1, s2 = skipconv.skip_conv_stats(*args)
        route = next((r for r, n in skipconv.skip_conv_stats.launches_by_route.items()
                      if n != routes[r]), None)
        ry, r1, r2 = skipconv.skip_conv_stats_plain(*args)
        torch.cuda.synchronize()
        errs = [(y.float() - ry.float()).abs().max().item(), (s1 - r1).abs().max().item(),
                (s2 - r2).abs().max().item()]
        scales = [ry.float().abs().max().item(), r1.abs().max().item(), r2.abs().max().item()]
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (y, s1, s2))
        ms = cuda_ms(lambda: skipconv.skip_conv_stats(*args), 50, queued=True)
        unqueued_ms = cuda_ms(lambda: skipconv.skip_conv_stats(*args), 50)
        plain_ms = cuda_ms(lambda: skipconv.skip_conv_stats_plain(*args), 20, queued=True)
        lib_ms = cuda_ms(lambda: torch.baddbmm(r3, wb, xcat), 50, queued=True)
    nbytes = (N * (c1 + c2 + 2 * F) * P + F * K + F) * esize + 2 * N * F * 4
    flops = 2 * N * P * K * F
    b_ms, b_by = bound(nbytes, flops, dname)
    rel = (1e-5, 1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-3, 2e-3)
    limits = [r * sc for r, sc in zip(rel, scales)]
    row = {"phase": "kernel", "path": path, "name": "skip_conv_stats", "ds": level,
           "dtype": dname, "N": N, "c1": c1, "c2": c2, "F": F, "M": N * P, "route": route, "plan": plan._asdict(),
           "err_y": errs[0], "err_s1": errs[1],
           "err_s2": errs[2], "max_abs_ref": scales, "limit_abs": limits,
           "max_abs_err": errs[0], "ms": ms, "unqueued_ms": unqueued_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms,
           "library": "baddbmm(resid, W, cat(x1, x2)): y without bias and statistics",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}
    emit(row)
    if plan.route != route or (path == "flagship" and route != SKIP_ROUTES[dname]):
        raise RuntimeError(f"skip_conv_stats {path} {shape} {dname} took route {route} (plan "
                           f"{plan.route}), expected {SKIP_ROUTES[dname]}")
    if not finite:
        raise RuntimeError(f"skip_conv_stats {shape} {dname}: non-finite output")
    for what, e, lim in zip(("y", "s1", "s2"), errs, limits):
        if not e <= lim:
            raise RuntimeError(f"skip_conv_stats {shape} {dname}: {what} max abs err {e} > {lim}")
    return row


def _sdpa(Fn, backend=None):
    """One PyTorch call computing the spatial function: SDPA on the 4-D view
    (B·T, H, D, F) of q, k and v with scale 1 (q arrives pre-scaled), pinned
    to ``backend`` (an ``SDPBackend`` name; None leaves the choice to
    PyTorch). The fused backends take only 4-D inputs; a pinned backend that
    refuses the inputs raises, with no fallback to the math path. A
    yardstick only; the port never calls it."""

    def run(q, k, v):
        B, T, H, D, F = q.shape
        q4, k4, v4 = (t.reshape(B * T, H, D, F) for t in (q, k, v))
        if backend is None:
            pin = contextlib.nullcontext()
        else:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            pin = sdpa_kernel(getattr(SDPBackend, backend))
        with pin:
            return Fn.scaled_dot_product_attention(q4, k4, v4, scale=1.0).reshape(q.shape)

    return run


def kernels_line(results, launches_by_path, routes_by_path):
    """One entry per kernel: numbers for the work of one flagship U-Net
    forward in bf16 (attention: 3 launches at ds 8 + 4 at ds 16; skip
    projection: its 10 up-path shapes). ``launches`` is the count of the
    training path (the flagship's main path); the other paths' counts are
    beside it, and the spatial and skip-projection kernels' counts by route
    on every path. ``latent`` holds the same numbers for one latent U-Net
    forward, with a row per launch shape."""
    entries = []
    for name in KERNEL_NAMES:
        if name == "skip_conv_stats":
            rows = [(results[("skip_conv_stats",) + shp + ("bfloat16",)], 1)
                    for shp in SKIP_SHAPES]
            unit = "one flagship U-Net forward, bf16: the 10 up-path skip projections"
            latent = [(results[("latent", name) + shp + ("bfloat16",)], 1)
                      for shp in LATENT_SKIP_SHAPES]
            latent_unit = "one latent U-Net forward (B=1, K=5), bf16: the 8 skip projections"
        else:
            rows = [(results[(name, ds, "bfloat16")], shp["per_forward"])
                    for ds, shp in ATTN_SHAPES.items()]
            unit = "one flagship U-Net forward, bf16: 3 launches at ds8 + 4 at ds16"
            latent = [(results[("latent", name, ds, "bfloat16")], shp["per_forward"])
                      for ds, shp in LATENT_ATTN_SHAPES.items()]
            latent_unit = "one latent U-Net forward (B=1, K=5), bf16: 3 at ds2 + 3 at ds4 + 1 at ds8"
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches_by_path["train"][name],
                 "launches_by_path": {path: c[name] for path, c in launches_by_path.items()},
                 **_summed(rows), "unit": unit}
        entry["latent"] = dict(_summed(latent), unit=latent_unit, per_launch=[
            {k: r.get(k) for k in ("ds", "shape", "N", "c1", "c2", "F", "M", "route", "ms",
                                   "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err")} | {"per_forward": n}
            for r, n in latent])
        if name in ROUTED:
            entry["launches_by_route"] = {path: r[name] for path, r in routes_by_path.items()}
        if name == "spatial_attention":
            entry["library"] = rows[0][0]["library"]
        entries.append(entry)
    return {"kernels": entries}


def _summed(rows):
    """The contract's numbers over (row, launches) pairs: times summed, the
    bound of the summed bytes and operations, the largest error."""
    nbytes = sum(r["bytes"] * n for r, n in rows)
    flops = sum(r["flops"] * n for r, n in rows)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    lib = [r["library_ms"] for r, _ in rows]
    return {"max_abs_err": max(r["max_abs_err"] for r, _ in rows),
            "ms": sum(r["ms"] * n for r, n in rows),
            "plain_ms": sum(r["plain_ms"] * n for r, n in rows),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if None in lib else sum(x * n for x, (_, n) in zip(lib, rows))}


# ---------------------------------------------------------------------------
# Phase 4: flagship U-Net forward, kernel path vs plain path
# ---------------------------------------------------------------------------


ZERO_MODULE_SCALE = 0.1


def randomize_zero_modules(model, gen):
    """Give the zero-initialised layers (each residual branch's last conv,
    each attention's output projection, the RPE nets' output, the head)
    uniform values within 1/10 of the torch-default bound: a fresh model's
    zero head outputs exactly 0, which would make every comparison vacuous.
    At the full default bound every residual branch is as large as its skip
    path and the random network turns chaotic: it amplifies a single bf16
    rounding difference anywhere to ~1% of its output, whatever the kernels
    do (phase 4 prints the bf16-vs-f32 distance of the plain path for
    scale)."""
    import math

    import torch

    from lfvdm_tpu_torch.models.nn import Conv2d, Linear

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, Conv2d)) and m.zero:
                b = ZERO_MODULE_SCALE / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-b, b, generator=gen))
    return model


def flagship_model(device, compute_dtype="bfloat16"):
    import torch

    from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config

    cfg = dict(flagship_config(), timestep_respacing="50", compute_dtype=compute_dtype)
    model, diffusion = create_model_and_diffusion(cfg, device=device, seed=0)
    randomize_zero_modules(model, torch.Generator().manual_seed(1))
    return cfg, model, diffusion


def latent_model(device, compute_dtype="bfloat16"):
    """The latent config at full width with the flagship's seeded weights."""
    import torch

    from lfvdm_tpu_torch.config import create_model_and_diffusion, latent_config

    cfg = dict(latent_config(), timestep_respacing=LATENT_RESPACING, compute_dtype=compute_dtype)
    model, diffusion = create_model_and_diffusion(cfg, device=device, seed=0)
    randomize_zero_modules(model, torch.Generator().manual_seed(1))
    return cfg, model, diffusion


def window_inputs(cfg, device, gen, B=FLAGSHIP_B, K=FLAGSHIP_K, n_obs=10, n_latent=8):
    """One window: 10 observed, 8 latent and 2 padding frames."""
    import torch

    C, S = cfg["in_channels"], cfg["image_size"]
    x = torch.randn(B, K, C, S, S, generator=gen, device=device)
    x0 = torch.rand(B, K, C, S, S, generator=gen, device=device) * 2 - 1
    fi = torch.sort(torch.randperm(60, generator=gen, device=device)[:K])[0]
    fi = fi[None].expand(B, K).contiguous()
    obs = torch.zeros(B, K, 1, 1, 1, device=device)
    obs[:, :n_obs] = 1
    lat = torch.zeros_like(obs)
    lat[:, n_obs:n_obs + n_latent] = 1
    t = torch.tensor([500.0, 120.0], device=device)[:B]
    return x, t, dict(x0=x0, frame_indices=fi, obs_mask=obs, latent_mask=lat)


def phase_unet(cfg, model, latent=False):
    """The bf16 forward (flagship, or the latent config's with ``latent``) on
    the kernel path against the plain path (relative L2 <= 5e-3), and the
    same weights in f32 (TF32 off), where the two paths differ only by
    summation order (relative L2 <= 1e-4)."""
    import torch

    from lfvdm_tpu_torch.models.unet import attention_blocks, fused_skip_blocks
    from lfvdm_tpu_torch.ops import attention as ops

    if latent:
        path, build, blocks = "latent", latent_model, (7, 8)
        per_forward, route_counts = LATENT_PER_FORWARD, latent_route_counts(_sms())
        window = LATENT_WINDOW
    else:
        path, build, blocks = "flagship", flagship_model, (7, 10)
        per_forward, route_counts, window = PER_FORWARD, None, {}
    n_blocks = (attention_blocks(model), fused_skip_blocks(model))
    if n_blocks != blocks:
        raise RuntimeError(f"{path} U-Net has {n_blocks} attention and skip-projection "
                           f"blocks, expected {blocks}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, t, kw = window_inputs(cfg, "cuda", gen, **window)
    with torch.no_grad():
        ops.reset_launch_counts()
        out, _ = model(x, t, **kw)
        torch.cuda.synchronize()
        counts, routes = read_counts()
        ref, _ = model(x, t, impl="plain", **kw)
        if ops.launch_counts() != counts:
            raise RuntimeError("the plain path launched a kernel")
        ms = cuda_ms(lambda: model(x, t, **kw), 10)
        plain_ms = cuda_ms(lambda: model(x, t, impl="plain", **kw), 10)
        unfused, unfused_ms, fused_ms = _unfused(model, x, t, kw)
        _, model32, _ = build("cuda", compute_dtype="float32")
        out32, _ = model32(x, t, **kw)
        ref32, _ = model32(x, t, impl="plain", **kw)
        unfused32 = _unfused(model32, x, t, kw, time_it=False)[0]
        del model32

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    row = {"phase": "unet", "path": path, "shape": list(x.shape), "dtype": "bfloat16",
           "launches_per_forward": counts, "routes_per_forward": routes,
           "rel_l2_vs_plain": rel(out, ref),
           "f32_rel_l2_vs_plain": rel(out32, ref32), "bf16_plain_vs_f32_plain": rel(ref, ref32),
           "fused_vs_unfused_rel_l2": rel(out, unfused),
           "f32_fused_vs_unfused_rel_l2": rel(out32, unfused32),
           "max_abs_out": ref.abs().max().item(), "ms_per_forward": ms,
           "plain_ms_per_forward": plain_ms, "fused_ms_per_forward": fused_ms,
           "unfused_ms_per_forward": unfused_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    if not (torch.isfinite(out).all() and torch.isfinite(out32).all()):
        raise RuntimeError("U-Net output is not finite")
    if ref.abs().max().item() == 0.0:
        raise RuntimeError("U-Net output is exactly zero: the comparison would be vacuous")
    _check_launches(counts, routes, 1, per_forward, route_counts)
    for key, limit in (("rel_l2_vs_plain", 5e-3), ("f32_rel_l2_vs_plain", 1e-4),
                       ("fused_vs_unfused_rel_l2", 1e-2), ("f32_fused_vs_unfused_rel_l2", 1e-4)):
        if not row[key] <= limit:
            raise RuntimeError(f"U-Net {key} = {row[key]} > {limit}")
    return row


def _unfused(model, x, t, kw, time_it=True):
    """The forward with the skip projection unfused (1x1 conv + add, sums
    read again), and ms per forward unfused and fused, timed in turns
    (fused, unfused, unfused, fused)."""
    import torch

    def run(fused):
        model.fused_skip_conv = fused
        return model(x, t, **kw)[0]

    try:
        out = run(False)
        if not time_it:
            return out, None, None
        times = {True: [], False: []}
        for fused in (True, False, False, True):
            times[fused].append(cuda_ms(lambda: run(fused), 5))
    finally:
        model.fused_skip_conv = True
    torch.cuda.synchronize()
    return out, sum(times[False]) / 2, sum(times[True]) / 2


def phase_profile(cfg, model, forwards: int = 3, path="flagship", window=None):
    """Where one forward's device time goes (the flagship's, or another
    path's with its ``window_inputs`` sizes): torch.profiler over a few
    kernel-path forwards; device time per forward by kernel name (top 25),
    the port kernels' share, and the device's idle share of the forward's
    wall time measured without the profiler (whose host-side cost would
    otherwise count as idle)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(5)
    x, t, kw = window_inputs(cfg, "cuda", gen, **(window or {}))
    with torch.no_grad():
        wall_ms = cuda_ms(lambda: model(x, t, **kw), forwards)  # without the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                model(x, t, **kw)
            torch.cuda.synchronize()
    per_kernel = device_kernels_ms(prof, forwards)
    busy = sum(per_kernel.values())
    attn = {name: sum(ms for k, ms in per_kernel.items() if f"{name}_" in k)
            for name in KERNEL_NAMES}
    syncs = _host_syncs(prof, forwards)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    emit({"phase": "profile", "path": path, "forwards": forwards, "wall_ms_per_forward": wall_ms,
          "groups_ms_per_forward": group_ms(per_kernel),
          "device_busy_ms_per_forward": busy,
          "idle_share": 1 - busy / wall_ms if busy else None,
          "port_kernels_ms_per_forward": attn, "host_syncs_per_forward": syncs,
          "top_device_ms_per_forward": [[k[:90], ms] for k, ms in top],
          "note": None if busy else "the profiler saw no device time; phase 4 times by CUDA events"})


# ---------------------------------------------------------------------------
# Phase 5: the main path — a long video through VideoSampler.sample_video
# ---------------------------------------------------------------------------


def phase_sample(cfg, model, diffusion):
    import numpy as np
    import torch

    from lfvdm_tpu_torch.config import create_diffusion
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.sampling.driver import VideoSampler

    B, T, C, S = FLAGSHIP_B, 40, cfg["in_channels"], cfg["image_size"]
    n_obs, max_frames, step_size = 10, FLAGSHIP_K, 10
    video = np.random.default_rng(3).uniform(-1, 1, (B, T, C, S, S)).astype(np.float32)
    gen = torch.Generator(device="cuda").manual_seed(4)

    sampler = VideoSampler(model, diffusion)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, used = sampler.sample_video(video, scheme_name="autoreg", n_obs=n_obs,
                                         max_frames=max_frames, step_size=step_size,
                                         generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts()
    calls = sampler.model_calls
    row = {"phase": "sample_video", "sampler": "ancestral", "respacing": "50",
           "video": [B, T, C, S, S], "windows": len(used),
           "window_frames": [len(o[0]) + len(lt[0]) for o, lt in used],
           "model_calls": calls, "launches": launches, "routes": routes, "wall_s": wall,
           "s_per_window": wall / len(used), "ms_per_model_call": wall / calls * 1e3}
    emit(row)
    _check_video(samples, video, n_obs, used, T)
    if len(used) != 3 or any(n != FLAGSHIP_K for n in row["window_frames"]):
        raise RuntimeError(f"expected 3 windows of {FLAGSHIP_K} frames, got {row['window_frames']}")
    _check_launches(launches, routes, calls)

    # One window each of DDIM (eta 0) and DPM-Solver++ on the first window.
    obs_idx, lat_idx = used[0]
    fi = np.asarray([list(o) + list(lt) for o, lt in zip(obs_idx, lat_idx)], np.int64)
    x0 = np.stack([samples[b, fi[b]] for b in range(B)])
    obs = np.zeros((B, FLAGSHIP_K, 1, 1, 1), np.float32)
    obs[:, :n_obs] = 1
    rows = [row]
    for name, spacing, kwargs in (("ddim", "ddim25", dict(use_ddim=True, eta=0.0)),
                                  ("dpm", "dpm20", dict(use_dpm=True))):
        diff = create_diffusion(dict(cfg, timestep_respacing=spacing))
        s = VideoSampler(model, diff, **kwargs)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = s.sample_window(x0, fi, obs, 1 - obs, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = read_counts()
        r = {"phase": "sample_window", "sampler": name, "respacing": spacing,
             "model_calls": s.model_calls, "launches": launches, "routes": routes,
             "wall_s": wall,
             "ms_per_model_call": wall / s.model_calls * 1e3,
             "max_abs": out.abs().max().item()}
        emit(r)
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{name} window is not finite")
        _check_launches(launches, routes, s.model_calls)
        rows.append(r)
    emit(_profile_window(cfg, model, x0, fi, obs, gen))
    return row["launches"], row["routes"], rows


SYNC_EVENTS = ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _host_syncs(prof, per):
    """Host waits on the device seen by the profiler, per unit of work: scalar
    reads back (``.item()`` and the like) and explicit synchronisations."""
    counts = {}
    for e in prof.key_averages():
        if e.key in SYNC_EVENTS:
            counts[e.key] = counts.get(e.key, 0) + e.count / per
    return counts


def _profile_window(cfg, model, x0, fi, obs, gen, spacing="ddim10"):
    """Device-busy time per model call of a DDIM window under torch.profiler,
    beside the same window's wall time per call without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lfvdm_tpu_torch.config import create_diffusion
    from lfvdm_tpu_torch.sampling.driver import VideoSampler

    s = VideoSampler(model, create_diffusion(dict(cfg, timestep_respacing=spacing)),
                     use_ddim=True, eta=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.sample_window(x0, fi, obs, 1 - obs, generator=gen)
    torch.cuda.synchronize()
    calls = s.model_calls
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.sample_window(x0, fi, obs, 1 - obs, generator=gen)
        torch.cuda.synchronize()
    busy = sum(device_kernels_ms(prof, calls).values())
    return {"phase": "sample_profile", "respacing": spacing, "model_calls": calls,
            "wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy,
            "idle_share": 1 - busy / wall_ms, "host_syncs_per_call": _host_syncs(prof, calls)}


def _check_video(samples, video, n_obs, used, T):
    import numpy as np

    if not np.isfinite(samples).all():
        raise RuntimeError("sampled video is not finite")
    if not np.array_equal(samples[:, :n_obs], video[:, :n_obs]):
        raise RuntimeError("observed frames were not kept")
    covered = set(range(n_obs)) | {i for _, lat in used for i in lat[0]}
    if covered != set(range(T)):
        raise RuntimeError(f"frames never generated: {sorted(set(range(T)) - covered)}")


def read_counts():
    """Launch counts by kernel, and the routed kernels' counts by route."""
    from lfvdm_tpu_torch.ops import attention as ops

    return ops.launch_counts(), {name: dict(getattr(ops, name).launches_by_route)
                                 for name in ROUTED}


def _check_launches(launches, routes, calls, per_forward=PER_FORWARD, route_counts=None):
    """``per_forward`` launches per model call, and the routed kernels'
    launches per model call by route as ``route_counts`` gives them (by
    default every spatial one on the bf16 "mma" route and every skip
    projection on the bf16 "bulk" route)."""
    if route_counts is None:
        route_counts = {name: {ROUTED[name]: per_forward[name]} for name in ROUTED}
    want = {name: n * calls for name, n in per_forward.items()}
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != {per_forward} per model call ({want})")
    want_routes = {name: {r: route_counts[name].get(r, 0) * calls for r in routes[name]}
                   for name in ROUTED}
    if routes != want_routes:
        raise RuntimeError(f"launches by route {routes} != {want_routes}")


def latent_route_counts(sms=None):
    """The routed kernels' launches per latent forward by route, as the
    shape rules give them: ``_spatial_route`` at each attention shape (bf16,
    aligned data) and ``skipconv.plan`` at each skip projection's sizes."""
    import torch

    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.ops import skipconv

    counts = {name: {} for name in ROUTED}
    spatial, skip = counts["spatial_attention"], counts["skip_conv_stats"]
    for shp in LATENT_ATTN_SHAPES.values():
        route = ops._spatial_route(torch.bfloat16, shp["D"], shp["F"], ())
        spatial[route] = spatial.get(route, 0) + shp["per_forward"]
    for _, c1, c2, F, S in LATENT_SKIP_SHAPES:
        route = skipconv.plan(LATENT_B * LATENT_K, c1, c2, F, S * S, torch.bfloat16,
                              sms=sms or skipconv.H100_SMS).route
        skip[route] = skip.get(route, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Phase 6: the training path — TrainLoop on the flagship config
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6  # timed steps
# Warm-up steps: the synthetic dataset renders its 16 videos on the host
# during its first epoch (2 batches of 2 per step), so the timed steps start
# once every video is cached.
TRAIN_WARMUP = 4
def phase_train(ckpt_dir):
    """TrainLoop at the flagship config over 128 px synthetic videos: the
    checks of the training path; returns its launch counts."""
    import torch

    from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
    from lfvdm_tpu_torch.data.datasets import load_data
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.training.train_loop import TrainLoop, train_step

    cfg = dict(flagship_config())
    rate = "0.9999"

    def new_loop(ckpt_dir, resume=False):
        model, diffusion = create_model_and_diffusion(cfg, device="cuda", seed=0)
        data = load_data("synthetic", batch_size=FLAGSHIP_B, image_size=cfg["image_size"])
        return TrainLoop(model=model, diffusion=diffusion, data=data, batch_size=FLAGSHIP_B,
                         max_frames=FLAGSHIP_K, lr=1e-4, ema_rate=rate, log_interval=1000,
                         save_interval=0, checkpoint_dir=ckpt_dir, config=cfg, seed=0,
                         resume=resume)

    loop = new_loop(ckpt_dir)
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        loop.run_step()
        loop.step += 1
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    named = dict(loop.model.named_parameters())
    p_before = {n: p.detach().clone() for n, p in named.items()}
    ema_leaf = "output_blocks.0.0.skip_connection.weight"

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    step_s, losses = [], []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:
            e_before = loop.state.ema[rate][ema_leaf].clone()
        t0 = time.perf_counter()
        metrics = loop.run_step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loop.step += 1
        losses.append(metrics["loss"].float().cpu().tolist())
    launches, routes = read_counts()
    peak = torch.cuda.max_memory_allocated()
    r = float(rate)
    want_ema = e_before * r + named[ema_leaf].detach() * (1 - r)
    ema_err = (loop.state.ema[rate][ema_leaf] - want_ema).abs().max().item()
    moved = max((p.detach() - p_before[n]).abs().max().item() for n, p in named.items())

    # The host's share of a step: drawing, masking and uploading one batch.
    t0 = time.perf_counter()
    for _ in range(3):
        loop.next_step_inputs()
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) / 3 * 1e3

    # One step in two microbatches: twice the forwards.
    batch, t, w, _, _ = loop.next_step_inputs()
    ops.reset_launch_counts()
    m2 = train_step(loop.state, batch, t, w, diffusion=loop.diffusion, generator=loop.generator,
                    n_microbatches=2)
    torch.cuda.synchronize()
    micro_launches = ops.launch_counts()

    # One step on a batch holding a NaN: nothing may change.
    batch, t, w, _, _ = loop.next_step_inputs()
    batch["x0"][0, 0, 0, 0, 0] = float("nan")
    before = _clone(loop.state.state_dict())
    m_nan = train_step(loop.state, batch, t, w, diffusion=loop.diffusion,
                       generator=loop.generator)
    after = loop.state.state_dict()
    nan_unchanged = _states_equal(before, after, ignore_step=True)

    # Save and resume into a fresh loop (a new model and optimizer).
    t0 = time.perf_counter()
    loop.save()
    saved = loop.state.state_dict()
    resumed = new_loop(ckpt_dir, resume=True)
    resume_equal = _states_equal(saved, resumed.state.state_dict()) and resumed.step == loop.step
    save_resume_s = time.perf_counter() - t0
    del resumed

    # A profile of one step by kernel group.
    profile = _profile_train_step(loop)

    row = {"phase": "train", "config": "flagship", "B": FLAGSHIP_B, "K": FLAGSHIP_K,
           "dtype": cfg["compute_dtype"], "dataset": "synthetic 128 px, T=100",
           "warmup_steps": TRAIN_WARMUP, "warmup_s": warm_s, "steps": TRAIN_STEPS, "ms_per_step": [x * 1e3 for x in step_s],
           "mean_ms_per_step": sum(step_s) / len(step_s) * 1e3,
           "peak_mem_gib": peak / 2**30, "host_batch_prep_ms": prep_ms, "losses": losses, "param_max_change": moved,
           "ema_formula_max_abs_err": ema_err, "launches": launches, "routes": routes,
           "microbatch_launches": micro_launches,
           "microbatch_loss": m2["weighted_loss"].item(),
           "nan_step_skipped": m_nan["skipped_nonfinite"].item(),
           "nan_step_unchanged": nan_unchanged, "save_resume_equal": resume_equal,
           "save_resume_s": save_resume_s, "profile": profile}
    emit(row)
    if not all(math.isfinite(x) for step in losses for x in step):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not moved > 0:
        raise RuntimeError("the parameters did not change")
    if not ema_err <= 1e-6 * max(want_ema.abs().max().item(), 1e-30):
        raise RuntimeError(f"EMA leaf differs from e·r + p·(1 − r) by {ema_err}")
    _check_launches(launches, routes, TRAIN_STEPS)
    if micro_launches != {name: 2 * n for name, n in PER_FORWARD.items()}:
        raise RuntimeError(f"microbatch launches {micro_launches} != twice {PER_FORWARD}")
    if not math.isfinite(m2["weighted_loss"].item()) or m2["skipped_nonfinite"].item():
        raise RuntimeError("the microbatch step failed")
    if m_nan["skipped_nonfinite"].item() != 1.0 or not nan_unchanged:
        raise RuntimeError("the non-finite step was not skipped cleanly")
    if not resume_equal:
        raise RuntimeError("the resumed state differs from the saved one")
    return launches, routes


def _clone(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _states_equal(a, b, ignore_step=False) -> bool:
    """Every tensor and count of two train-state dicts equal (on any device)."""
    import torch

    if isinstance(a, dict):
        keys = set(a) - ({"step"} if ignore_step else set())
        return set(a) == set(b) and all(_states_equal(a[k], b[k], ignore_step) for k in keys)
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def _profile_train_step(loop, steps: int = 2):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            loop.run_step()
            loop.step += 1
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    per_kernel = device_kernels_ms(prof, steps)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:30]
    return {"steps": steps, "wall_ms_per_step_profiled": wall_ms,
            "device_busy_ms_per_step": busy, "host_syncs_per_step": _host_syncs(prof, steps),
            "groups_ms_per_step": group_ms(per_kernel),
            "top_device_ms_per_step": [[k[:90], ms, kernel_group(k)] for k, ms in top]}


# ---------------------------------------------------------------------------
# Phase 7: one train step, kernel path against the plain path
# ---------------------------------------------------------------------------


def phase_train_parity():
    """From identical weights (random, zero layers at 1/10 scale), batch, t
    and noise: the loss and gradients of one step on the kernel path against
    impl="plain", in bf16 and in f32 with TF32 off (B=2, or B=1 if B=2 does
    not fit)."""
    import torch

    rows = []
    for compute_dtype in ("bfloat16", "float32"):
        for B in (FLAGSHIP_B, 1):
            try:
                rows.append(_parity_once(compute_dtype, B))
                break
            except torch.cuda.OutOfMemoryError:
                if B == 1:
                    raise
            torch.cuda.empty_cache()  # after the failed attempt's frames are gone
    bf16, f32 = rows
    if not bf16["loss_rel_err"] <= 1e-2:
        raise RuntimeError(f"bf16 train step: loss relative error {bf16['loss_rel_err']} > 1e-2")
    if not f32["loss_rel_err"] <= 1e-5:
        raise RuntimeError(f"f32 train step: loss relative error {f32['loss_rel_err']} > 1e-5")
    if not f32["grad_rel_l2"] <= 1e-4:
        raise RuntimeError(f"f32 train step: gradient relative L2 {f32['grad_rel_l2']} > 1e-4")


def _parity_once(compute_dtype, B):
    import numpy as np
    import torch

    from lfvdm_tpu_torch.config import create_diffusion
    from lfvdm_tpu_torch.training.masks import sample_training_batch
    from lfvdm_tpu_torch.training.train_loop import backward_microbatches

    cfg, model, _ = flagship_model("cuda", compute_dtype=compute_dtype)
    diffusion = create_diffusion(dict(cfg, timestep_respacing=""))  # training's 1000 steps
    rng = np.random.default_rng(6)
    C, S = cfg["in_channels"], cfg["image_size"]
    video = rng.uniform(-1, 1, (B, 60, C, S, S)).astype(np.float32)
    x0, fi, obs, lat = sample_training_batch(rng, video, FLAGSHIP_K, batch2=video[::-1])
    batch = {"x0": torch.tensor(x0, device="cuda"),
             "frame_indices": torch.tensor(fi, dtype=torch.int64, device="cuda"),
             "obs_mask": torch.tensor(obs, device="cuda"),
             "latent_mask": torch.tensor(lat, device="cuda")}
    t = torch.tensor(rng.integers(0, diffusion.num_timesteps, B), device="cuda")
    w = torch.ones(B, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    noise = torch.randn(x0.shape, generator=gen, device="cuda")
    model.train()
    out = {}
    for impl in ("auto", "plain"):
        model.zero_grad(set_to_none=True)
        loss, _ = backward_microbatches(model, diffusion, batch, t, w, noise=noise, impl=impl)
        out[impl] = (loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]))
    (lk, gk), (lp, gp) = out["auto"], out["plain"]
    row = {"phase": "train_parity", "dtype": compute_dtype, "B": B, "K": FLAGSHIP_K,
           "loss_kernel": lk, "loss_plain": lp, "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_rel_l2": ((gk - gp).norm() / gp.norm()).item(),
           "grad_norm": gp.norm().item(), "finite": bool(torch.isfinite(gk).all()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    del model, out, gk, gp
    torch.cuda.empty_cache()
    if not row["finite"]:
        raise RuntimeError(f"{compute_dtype} train step: non-finite gradients")
    return row



# ---------------------------------------------------------------------------
# Phase 8: the latent path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def torch_tf32_defaults():
    """PyTorch's own defaults inside (f32 convolutions in TF32 through
    cuDNN, f32 matmuls in full f32), whatever phase 3 set; restored after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class RecordingCodec:
    """A codec whose decode keeps the latents it was given, its wall time
    and the device memory it peaked at, then decodes through ``codec``."""

    def __init__(self, codec):
        self.codec = codec

    def decode(self, video):
        import torch

        self.latents = video.clone()
        torch.cuda.synchronize()
        self.mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self.codec.decode(video)
        torch.cuda.synchronize()
        self.decode_s = time.perf_counter() - t0
        self.peak = torch.cuda.max_memory_allocated()
        return out


class TimedEncode:
    """A codec whose encode's wall time (synchronised) is added up."""

    def __init__(self, codec):
        self.codec = codec
        self.encode_s = []

    def encode(self, video, generator=None):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.codec.encode(video, generator=generator)
        torch.cuda.synchronize()
        self.encode_s.append(time.perf_counter() - t0)
        return out


def latent_stats(seed=20):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.5, 4).astype(np.float32), rng.uniform(0.5, 1.5, 4).astype(np.float32)


def phase_latent_sample(cfg, model, diffusion, vae, card):
    """A 20-frame latent video through VideoSampler with the pre-encoded
    codec over the full-width VAE: the observed latent frames kept exactly
    before the decode, a finite (1, 20, 3, 256, 256) video after it, and
    7 + 7 + 8 launches per model call on the routes the rules give."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch.diffusion.codecs import PreEncodedLatentCodec
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.sampling.driver import VideoSampler

    B, T, C, S = LATENT_B, LATENT_VIDEO_T, cfg["in_channels"], cfg["image_size"]
    n_obs = 2
    video = np.random.default_rng(21).standard_normal((B, T, C, S, S)).astype(np.float32)
    codec = RecordingCodec(PreEncodedLatentCodec(*latent_stats(), vae=vae))
    sampler = VideoSampler(model, diffusion, codec=codec)
    gen = torch.Generator(device="cuda").manual_seed(22)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pixels, used = sampler.sample_video(video, scheme_name="autoreg", n_obs=n_obs,
                                        max_frames=LATENT_K, step_size=2, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts()
    calls = sampler.model_calls
    sample_s = wall - codec.decode_s
    row = {"phase": "latent_sample", "card": card, "sampler": "ancestral",
           "respacing": LATENT_RESPACING, "latent_video": [B, T, C, S, S],
           "decoded": list(pixels.shape), "windows": len(used),
           "window_frames": [len(o[0]) + len(lt[0]) for o, lt in used], "model_calls": calls,
           "launches": launches, "routes": routes, "wall_s": wall, "sampling_s": sample_s,
           "ms_per_model_call": sample_s / calls * 1e3, "decode_s": codec.decode_s,
           "decode_ms_per_frame": codec.decode_s / (B * T) * 1e3,
           "vae_decode_peak_mem_gib": codec.peak / 2**30,
           "vae_decode_added_mem_gib": (codec.peak - codec.mem_before) / 2**30,
           "vae_params": sum(p.numel() for p in vae.parameters()),
           "max_abs_pixel": float(np.abs(pixels).max())}
    emit(row)
    _check_video(codec.latents.cpu().numpy(), video, n_obs, used, T)
    if pixels.shape != (B, T, 3, 8 * S, 8 * S) or not np.isfinite(pixels).all():
        raise RuntimeError(f"decoded video {pixels.shape} is not a finite (1, 20, 3, 256, 256)")
    _check_launches(launches, routes, calls, LATENT_PER_FORWARD, latent_route_counts(_sms()))
    return launches, routes


def _sms():
    from lfvdm_tpu_torch.ops import skipconv

    return skipconv._sm_count(0)


def phase_vae_cpu(vae, card):
    """Encode (the mean) and decode of one 64 px frame on the card against
    the same weights in f32 on this machine's CPU, at PyTorch's TF32
    defaults (the bound, relative L2 <= 1e-2) and with TF32 off."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch.models.vae import SVDVae

    cpu = SVDVae({k: v.cpu() for k, v in vae.state_dict().items()}, device="cpu")
    rng = np.random.default_rng(24)
    frame = rng.uniform(-1, 1, (1, 1, 3, 64, 64)).astype(np.float32)
    z = rng.standard_normal((1, 1, 4, 8, 8)).astype(np.float32)
    t0 = time.perf_counter()
    ref_z, ref_x = cpu.encode_video(frame), cpu.decode_video(z)
    cpu_s = time.perf_counter() - t0

    def rel(a, b):
        return ((a.cpu() - b).norm() / b.norm()).item()

    row = {"phase": "latent_vae_vs_cpu", "card": card, "frame": [64, 64], "latent": [8, 8],
           "cpu_s": cpu_s}
    for label, tf32 in (("tf32_default", True), ("tf32_off", False)):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            row[f"encode_rel_l2_{label}"] = rel(vae.encode_video(frame), ref_z)
            row[f"decode_rel_l2_{label}"] = rel(vae.decode_video(z), ref_x)
    emit(row)
    del cpu
    for key in ("encode_rel_l2_tf32_default", "decode_rel_l2_tf32_default"):
        if not row[key] <= 1e-2:
            raise RuntimeError(f"VAE card vs CPU: {key} = {row[key]} > 1e-2")


LATENT_TRAIN_STEPS = {"pre_encoded": 3, "vae_online": 2}


def phase_latent_train(ckpt_root, vae, card):
    """TrainLoop on the latent config: steps over an EncodedNpyDataset of
    seeded latents in a temporary directory, then steps with VAECodec
    encoding 256 px synthetic frames on the card. Finite losses and 7 + 7 +
    8 launches per step on the rules' routes."""
    import numpy as np

    from lfvdm_tpu_torch.data.datasets import EncodedNpyDataset, batch_generator, load_data
    from lfvdm_tpu_torch.diffusion.codecs import PreEncodedLatentCodec, VAECodec

    tmp = tempfile.mkdtemp(prefix="chip_smoke_latents_", dir=ckpt_root)
    try:
        rng = np.random.default_rng(23)
        for i in range(4):
            np.save(os.path.join(tmp, f"{i}.npy"),
                    rng.standard_normal((LATENT_VIDEO_T, 4, 32, 32)).astype(np.float32))
        data = batch_generator(EncodedNpyDataset(tmp, T=LATENT_VIDEO_T), LATENT_B, seed=0)
        counts = _latent_steps("pre_encoded", data, PreEncodedLatentCodec(*latent_stats()),
                               ckpt_root, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    data = load_data("synthetic", batch_size=LATENT_B, T=LATENT_VIDEO_T, image_size=256)
    _latent_steps("vae_online", data, TimedEncode(VAECodec(vae=vae)), ckpt_root, card)
    return counts


def _latent_steps(kind, data, codec, ckpt_dir, card):
    """``LATENT_TRAIN_STEPS[kind]`` steps of a new TrainLoop (nothing is
    saved to ``ckpt_dir``); returns their launch counts and routes."""
    import torch

    from lfvdm_tpu_torch.config import create_model_and_diffusion, latent_config
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.training.train_loop import TrainLoop

    cfg = latent_config()
    model, diffusion = create_model_and_diffusion(cfg, device="cuda", seed=0)
    loop = TrainLoop(model=model, diffusion=diffusion, data=data, batch_size=LATENT_B,
                     max_frames=LATENT_K, lr=1e-4, log_interval=1000, save_interval=0,
                     checkpoint_dir=ckpt_dir, config=cfg, seed=0, codec=codec)
    steps = LATENT_TRAIN_STEPS[kind]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = loop.run_step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loop.step += 1
        losses.append(metrics["loss"].float().cpu().tolist())
    launches, routes = read_counts()
    row = {"phase": "latent_train", "card": card, "data": kind, "B": LATENT_B, "K": LATENT_K,
           "dtype": cfg["compute_dtype"], "steps": steps,
           "ms_per_step": [x * 1e3 for x in step_s], "losses": losses,
           "launches": launches, "routes": routes,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if isinstance(codec, TimedEncode):
        row["frames_px"] = 256
        row["encode_host_ms_per_step"] = [x * 1e3 for x in codec.encode_s]
    emit(row)
    if not all(math.isfinite(x) for step in losses for x in step):
        raise RuntimeError(f"latent training ({kind}): non-finite loss {losses}")
    _check_launches(launches, routes, steps, LATENT_PER_FORWARD, latent_route_counts(_sms()))
    return launches, routes


def phase_latent(ckpt_root, card):
    """The latent path's phases; returns its sampling and training launch
    counts and routes by path."""
    import torch

    from lfvdm_tpu_torch.models.vae import SVDVae

    cfg, model, diffusion = latent_model("cuda")
    phase_unet(cfg, model, latent=True)
    phase_profile(cfg, model, forwards=10, path="latent", window=LATENT_WINDOW)
    with torch_tf32_defaults():
        vae = SVDVae(seed=0, device="cuda")
        sample = phase_latent_sample(cfg, model, diffusion, vae, card)
        del model
        phase_vae_cpu(vae, card)
        train = phase_latent_train(ckpt_root, vae, card)
    del vae
    torch.cuda.empty_cache()
    return {"latent_sample": sample, "latent_train": train}

# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "lfvdm_tpu_torch")):
        print("chip_smoke: the lfvdm_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    t_start = time.perf_counter()

    card = phase_device()
    phase_build()
    results = phase_kernels()
    cfg, model, diffusion = flagship_model("cuda")
    phase_unet(cfg, model)
    phase_profile(cfg, model)
    sample_launches, sample_routes, _ = phase_sample(cfg, model, diffusion)
    del model
    ckpt_root = os.path.join(here, "checkpoints")
    os.makedirs(ckpt_root, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=ckpt_root)
    try:
        train_launches, train_routes = phase_train(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    phase_train_parity()
    latent = phase_latent(ckpt_root, card)
    launches = {"train": train_launches, "sample_video": sample_launches}
    routes = {"train": train_routes, "sample_video": sample_routes}
    for path, (c, r) in latent.items():
        launches[path], routes[path] = c, r
    emit(kernels_line(results, launches, routes))
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
