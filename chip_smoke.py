#!/usr/bin/env python3
"""Drive the PyTorch port (lfvdm_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises (non-zero exit):
  1. device  — the card's name and power limit (nvidia-smi); a card is required.
  2. build   — compiles every CUDA kernel from ops/csrc (one nvcc per source,
               in parallel) and times the build.
  3. kernels — each kernel against its plain PyTorch version at both flagship
               shapes (ds 8 and ds 16), in f32 (TF32 off) and bf16: errors, and
               CUDA-event times of the kernel, the plain version, one PyTorch
               library call where one exists (SDPA for spatial attention, a
               yardstick only) and the least time the card could take.
  4. unet    — the flagship U-Net (128 px, B=2, K=20, bf16, random non-zero
               weights) on the kernel path against the plain path (and the
               same weights in f32); 7 launches of each kernel per forward;
               then a torch.profiler breakdown of one forward's device time.
  5. sample  — the main path: VideoSampler.sample_video over a 40-frame video
               (autoreg, 3 windows of K=20, ancestral, 50 steps), then one DDIM
               (ddim25) and one DPM-Solver++ (dpm20) window. Launch counts are
               reset just before and read just after; each must equal 7 per
               model call.
  6. the "kernels" summary line, then {"ok": true, "device": {...}} last.

Exits non-zero without printing a result when no CUDA device is present or
when the lfvdm_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
REPLACES = {
    "temporal_rpe_attention": "lfvdm_tpu/ops/attention.py:210 (_temporal_pallas -> _temporal_kernel :143)",
    "spatial_attention": "lfvdm_tpu/ops/attention.py:106 (_spatial_pallas -> _spatial_kernel :81)",
}
SOURCES = {"temporal_rpe_attention": "lfvdm_tpu_torch/ops/csrc/temporal_rpe_attention.cu",
           "spatial_attention": "lfvdm_tpu_torch/ops/csrc/spatial_attention.cu"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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
    """Kernel-layout inputs; the mask holds 10 observed, 8 latent and 2
    padding frames (mask 0), so both groups of the two-group softmax occur."""
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
    import torch
    import torch.nn.functional as Fn

    from lfvdm_tpu_torch.ops import attention as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        esize = torch.finfo(dtype).bits // 8
        for ds, shp in ATTN_SHAPES.items():
            H, D, F = shp["H"], shp["D"], shp["F"]
            cases = {
                "temporal_rpe_attention": (
                    temporal_inputs(H, D, F, dtype, gen), ops.temporal_rpe_attention,
                    ops.temporal_rpe_attention_plain, None, temporal_work(H, D, F, esize)),
                "spatial_attention": (
                    spatial_inputs(H, D, F, dtype, gen), ops.spatial_attention,
                    ops.spatial_attention_plain, _sdpa(Fn), spatial_work(H, D, F, esize)),
            }
            for name, (args, kernel, plain, library, (nbytes, flops)) in cases.items():
                with torch.no_grad():
                    out = kernel(*args)
                    ref = plain(*args)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    if not torch.isfinite(out.float()).all():
                        raise RuntimeError(f"{name} {ds} {dname}: non-finite output")
                    ms = cuda_ms(lambda: kernel(*args), 50)
                    plain_ms = cuda_ms(lambda: plain(*args), 20)
                    lib_ms = cuda_ms(lambda: library(*args), 50) if library else None
                b_ms, b_by = bound(nbytes, flops, dname)
                limit = 1e-4 if dtype == torch.float32 else 2e-2 * scale
                row = {"phase": "kernel", "name": name, "ds": ds, "dtype": dname,
                       "shape": list(args[0].shape), "max_abs_err": err, "max_abs_ref": scale,
                       "rel_err": err / scale, "limit_abs": limit, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "bytes": nbytes, "flops": flops}
                emit(row)
                if not err <= limit:
                    raise RuntimeError(f"{name} {ds} {dname}: max abs err {err} > {limit}")
                results[(name, ds, dname)] = row
    return results


def _sdpa(Fn):
    """One PyTorch call computing the spatial function: SDPA on (B·T·H, D, F)
    with scale 1 (q arrives pre-scaled). A yardstick only; the port never
    calls it."""

    def run(q, k, v):
        B, T, H, D, F = q.shape
        return Fn.scaled_dot_product_attention(
            q.reshape(-1, D, F), k.reshape(-1, D, F), v.reshape(-1, D, F), scale=1.0)

    return run


def kernels_line(results, launches):
    """One entry per kernel: numbers for the work of one flagship U-Net
    forward in bf16 (3 launches at ds 8 + 4 at ds 16)."""
    entries = []
    for name in ("temporal_rpe_attention", "spatial_attention"):
        rows = [(results[(name, ds, "bfloat16")], shp["per_forward"])
                for ds, shp in ATTN_SHAPES.items()]
        nbytes = sum(r["bytes"] * n for r, n in rows)
        flops = sum(r["flops"] * n for r, n in rows)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        lib = [r["library_ms"] for r, _ in rows]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r, _ in rows),
            "ms": sum(r["ms"] * n for r, n in rows),
            "plain_ms": sum(r["plain_ms"] * n for r, n in rows),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if None in lib else sum(x * n for x, (_, n) in zip(lib, rows)),
            "unit": "one flagship U-Net forward, bf16: 3 launches at ds8 + 4 at ds16",
        })
    return {"kernels": entries}


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


def phase_unet(cfg, model):
    """The bf16 flagship forward on the kernel path against the plain path
    (relative L2 <= 1e-2), and the same weights in f32 (TF32 off), where the
    two paths differ only by summation order (relative L2 <= 1e-4)."""
    import torch

    from lfvdm_tpu_torch.models.unet import attention_blocks
    from lfvdm_tpu_torch.ops import attention as ops

    n_blocks = attention_blocks(model)
    if n_blocks != 7:
        raise RuntimeError(f"flagship U-Net has {n_blocks} attention blocks, expected 7")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, t, kw = window_inputs(cfg, "cuda", gen)
    with torch.no_grad():
        ops.reset_launch_counts()
        out, _ = model(x, t, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ref, _ = model(x, t, impl="plain", **kw)
        if ops.launch_counts() != counts:
            raise RuntimeError("the plain path launched a kernel")
        ms = cuda_ms(lambda: model(x, t, **kw), 10)
        plain_ms = cuda_ms(lambda: model(x, t, impl="plain", **kw), 10)
        _, model32, _ = flagship_model("cuda", compute_dtype="float32")
        out32, _ = model32(x, t, **kw)
        ref32, _ = model32(x, t, impl="plain", **kw)
        del model32

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    row = {"phase": "unet", "shape": list(x.shape), "dtype": "bfloat16",
           "launches_per_forward": counts, "rel_l2_vs_plain": rel(out, ref),
           "f32_rel_l2_vs_plain": rel(out32, ref32), "bf16_plain_vs_f32_plain": rel(ref, ref32),
           "max_abs_out": ref.abs().max().item(), "ms_per_forward": ms,
           "plain_ms_per_forward": plain_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    if not (torch.isfinite(out).all() and torch.isfinite(out32).all()):
        raise RuntimeError("U-Net output is not finite")
    if ref.abs().max().item() == 0.0:
        raise RuntimeError("U-Net output is exactly zero: the comparison would be vacuous")
    if counts != {"temporal_rpe_attention": 7, "spatial_attention": 7}:
        raise RuntimeError(f"expected 7 launches of each kernel per forward, got {counts}")
    if not row["rel_l2_vs_plain"] <= 1e-2:
        raise RuntimeError(f"bf16 kernel path vs plain path: relative L2 {row['rel_l2_vs_plain']} > 1e-2")
    if not row["f32_rel_l2_vs_plain"] <= 1e-4:
        raise RuntimeError(f"f32 kernel path vs plain path: relative L2 {row['f32_rel_l2_vs_plain']} > 1e-4")
    return row


def phase_profile(cfg, model, forwards: int = 3):
    """Where one flagship forward's device time goes: torch.profiler over a
    few kernel-path forwards; device time per forward by kernel name (top
    25), the two attention kernels' share, and the device's idle share of
    the forward's wall time measured without the profiler (whose host-side
    cost would otherwise count as idle)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(5)
    x, t, kw = window_inputs(cfg, "cuda", gen)
    with torch.no_grad():
        wall_ms = cuda_ms(lambda: model(x, t, **kw), forwards)  # without the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                model(x, t, **kw)
            torch.cuda.synchronize()
    per_kernel = {}  # device-side events only: CPU ops also report their kernels' time
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3 / forwards
        if e.device_type == DeviceType.CUDA and ms > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + ms
    busy = sum(per_kernel.values())
    attn = {name: sum(ms for k, ms in per_kernel.items() if f"{name}_kernel" in k)
            for name in ("temporal_rpe_attention", "spatial_attention")}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    emit({"phase": "profile", "forwards": forwards, "wall_ms_per_forward": wall_ms,
          "device_busy_ms_per_forward": busy,
          "idle_share": 1 - busy / wall_ms if busy else None,
          "attention_kernels_ms_per_forward": attn,
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
    launches = ops.launch_counts()
    calls = sampler.model_calls
    row = {"phase": "sample_video", "sampler": "ancestral", "respacing": "50",
           "video": [B, T, C, S, S], "windows": len(used),
           "window_frames": [len(o[0]) + len(lt[0]) for o, lt in used],
           "model_calls": calls, "launches": launches, "wall_s": wall,
           "s_per_window": wall / len(used), "ms_per_model_call": wall / calls * 1e3}
    emit(row)
    _check_video(samples, video, n_obs, used, T)
    if len(used) != 3 or any(n != FLAGSHIP_K for n in row["window_frames"]):
        raise RuntimeError(f"expected 3 windows of {FLAGSHIP_K} frames, got {row['window_frames']}")
    _check_launches(launches, calls)

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
        launches = ops.launch_counts()
        r = {"phase": "sample_window", "sampler": name, "respacing": spacing,
             "model_calls": s.model_calls, "launches": launches, "wall_s": wall,
             "ms_per_model_call": wall / s.model_calls * 1e3,
             "max_abs": out.abs().max().item()}
        emit(r)
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{name} window is not finite")
        _check_launches(launches, s.model_calls)
        rows.append(r)
    return row["launches"], rows


def _check_video(samples, video, n_obs, used, T):
    import numpy as np

    if not np.isfinite(samples).all():
        raise RuntimeError("sampled video is not finite")
    if not np.array_equal(samples[:, :n_obs], video[:, :n_obs]):
        raise RuntimeError("observed frames were not kept")
    covered = set(range(n_obs)) | {i for _, lat in used for i in lat[0]}
    if covered != set(range(T)):
        raise RuntimeError(f"frames never generated: {sorted(set(range(T)) - covered)}")


def _check_launches(launches, calls):
    want = {"temporal_rpe_attention": 7 * calls, "spatial_attention": 7 * calls}
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != 7 per model call ({want})")


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

    phase_device()
    phase_build()
    results = phase_kernels()
    cfg, model, diffusion = flagship_model("cuda")
    phase_unet(cfg, model)
    phase_profile(cfg, model)
    launches, _ = phase_sample(cfg, model, diffusion)
    emit(kernels_line(results, launches))
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
