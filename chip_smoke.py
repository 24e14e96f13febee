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
  5b. reuse  — encoder reuse and the heatmap sampler on the flagship model
               (phase_reuse): a. a 20-frame video of one window through
               VideoSampler(encoder_reuse=3), ancestral with 50 steps (17 full
               calls of 7 + 7 + 10 launches, 33 reuse calls of 4 + 4 + 10: the
               up path's attention blocks and skip projections, on "mma" and
               "bulk"), finite, observed frames kept, its relative L2 to the
               same video without reuse printed; one full and one reuse call
               timed (device busy and wall ms per call); b. the reuse call
               kernel vs plain on the same features (relative L2 <= 5e-3);
               c. sample_window_attn over 8 steps: eight finite heatmaps of
               the JAX shapes, 0 + 0 + 10 launches per call (the attention
               weights come from the einsum form). d. runs inside phase 9's
               fixture: video_sample --encoder_reuse 3 and --sampling_scheme
               adaptive-autoreg (LPIPS embedder on the card), and the
               embedder's ms per batch of 80 frames at 128 px.
  5c. serve  — the exported window sampler (lfvdm_tpu_torch.serving) on the
               flagship model (phase_serve): a. export_window_sampler, DDIM
               ddim25, eta 0: export seconds and artifact bytes; b. that
               artifact and params.npz served from a seed in a fresh subprocess
               that imports lfvdm_tpu_torch.serving and none of the model,
               config, diffusion or sampling modules: load seconds, ms per
               window and per step (CUDA events, wall), 25 x (7 + 7 + 10)
               launches on "mma"/"bulk"; c. the live window (VideoSampler DDIM,
               the same weights and initial noise) against the served one
               (relative L2 <= 5e-3), both timed in turns; d. an ancestral
               artifact (respacing 50): one finite window of the right shape,
               50 x (7 + 7 + 10) launches; e. after phase 6, on its run
               directory (phase_serve_params): export_params writes the EMA
               weights as a flax .msgpack, and video_sample's loader reads it
               into a U-Net whose output equals the run directory's, bitwise.
  6. train   — the training path: TrainLoop on the flagship config (B=2, K=20,
               bf16) over the synthetic dataset at 128 px (prefetched on a
               thread): warm-up steps, then timed steps (finite losses,
               parameters move, the EMA formula, 7 + 7 + 10 launches per step;
               the host batch time inside each step), the host batch time
               without the prefetch (three draws back to back), one step in
               two microbatches, one non-finite step that changes nothing, a
               checkpoint save and resume, and a profile of one step by kernel
               group.
  7. parity  — one train step's loss and gradients on the kernel path against
               impl="plain", in bf16 and in f32 (TF32 off).
  7b. parallel — data parallelism and remat (lfvdm_tpu_torch/parallel) on the
               flagship config, on the one card:
               a. remat  — one train step with use_checkpoint=True and one
                           without (dropout 0.1, the same masks): loss and
                           gradients within 5e-3 in bf16 and 1e-5 in f32;
                           peak memory and ms per step both ways; 14 + 14 + 20
                           launches per step with remat, 7 + 7 + 10 without;
               b. group of one — a NCCL group of one rank: TrainLoop
                           unwrapped, through DDP and through FSDP2 on a
                           (1, 1) mesh, 2 steps each on the same batches:
                           parameters and gradients within 5e-3 of the
                           unwrapped loop's, ms per step; the FSDP2 run saved
                           and resumed unwrapped, bitwise;
               c. two ranks — two processes on the card in a gloo group, B=1
                           each under DDP and under FSDP2 (fsdp 2), against
                           one process's B=2 step on the same rows and noise
                           (5e-3, each rank's shards where they lie);
                           7 + 7 + 10 launches per rank;
               d. sample — VideoSampler over two replicas on the card, a DDIM
                           window (ddim25, B=2) against one device's (5e-3),
                           both timed in turns.
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
  9. cli     — the entry points' main(argv), in process, at the flagship's
               full width, on a seeded CARLA-layout fixture (8 train and 4 test
               uint8 (100, 128, 128, 3) .pt videos, .npy siblings for the train
               split) in a temporary DATA_ROOT:
               a. video_sample on a reference-format .pt of the flagship model
                  (hierarchy-2, T=60, 10 observed, K=20, B=2, DDIM 25): two uint8
                  (60, 3, 128, 128) files whose observed frames are the test
                  videos' exactly; a second run writes nothing;
               b. video_train with the flags that give the flagship config, 4
                  steps served by the native loader, finite losses, a run
                  directory with config.json, the parameters and the EMA; the
                  vis sampler (make_sample_fn, 25 ancestral steps; gifs where
                  PIL is present) on the trained loop;
               c. video_sample on the run directory's raw weights, one window;
               d. ms per batch of the native, the Python-thread and the
                  synchronous loaders, and the train step's host batch time with
                  the prefetch against the synchronous generator.
               e. phase 5b d (above) on the same fixture.
               Every model call launches 7 + 7 + 10 kernels on "mma"/"bulk"
               (a reuse call 4 + 4 + 10).
 10. evals   — at PyTorch's TF32 defaults (the evals turn TF32 off in their own
               scope), on seeded fixtures in a temporary directory; no port
               kernel launches on this path:
               a. I3D on the card against the machine's CPU, one seeded
                  (1, 16, 224, 224, 3) f32 clip (relative L2 <= 1e-3);
               b. video_fvd.main with --real_dir on two sample-format sets of
                  16 uint8 videos (16 frames) at 128 px and at 256 px (the
                  antialiased resize): FVD of a set against itself |.| < 1,
                  between the sets finite and > 0; ms per video of features
                  and seconds per FVD;
               c. video_to_world_coords.main over the 128 px samples with a
                  seeded full ResNet-152 classifier and regressor saved as
                  torchvision-layout .pt (batch 64): one finite (16, 2) file
                  per video, a second run writes nothing, 4 frames card vs
                  CPU (relative L2 <= 1e-3), ms per frame;
               d. carla_regressor_train.main, one epoch of each mode on a
                  CARLA-layout fixture with coords_*.npy siblings (3 + 1
                  videos of 8 frames at 128 px): finite losses, and the
                  checkpoints it writes load into the predictor of c.
 11. the "kernels" summary line, then {"ok": true, "device": {...}} last.

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


# ---------------------------------------------------------------------------
# Phase 5b: encoder reuse and the attention-heatmap sampler
# ---------------------------------------------------------------------------

# Launches per model call on the reuse paths of the flagship U-Net. A reuse
# call runs only the up path and the head: its 4 attention blocks (2 at ds 16,
# 2 at ds 8) and its 10 skip projections, at the full call's shapes, so on the
# same "mma" and "bulk" routes. A heatmap call (return_attn_weights) takes
# every attention block's einsum form, which returns the weights; only its 10
# skip projections launch. reuse_forward_counts() derives both from the model.
REUSE_PER_FORWARD = {"temporal_rpe_attention": 4, "spatial_attention": 4, "skip_conv_stats": 10}
ATTN_PER_FORWARD = {"temporal_rpe_attention": 0, "spatial_attention": 0, "skip_conv_stats": 10}
REUSE_K = 3
REUSE_RESPACING = "50"
ATTN_RESPACING = "8"


def reuse_forward_counts(model):
    """(reuse call, heatmap call) launches per call, from ``model``'s blocks."""
    from lfvdm_tpu_torch.models.unet import FactorizedAttentionBlock, fused_skip_blocks

    up_attn = sum(isinstance(m, FactorizedAttentionBlock) for m in model.output_blocks.modules())
    skips = fused_skip_blocks(model)
    return ({"temporal_rpe_attention": up_attn, "spatial_attention": up_attn,
             "skip_conv_stats": skips},
            {"temporal_rpe_attention": 0, "spatial_attention": 0, "skip_conv_stats": skips})


def mixed_counts(full, reuse):
    """Launches of ``full`` full calls and ``reuse`` reuse calls."""
    return {name: PER_FORWARD[name] * full + REUSE_PER_FORWARD[name] * reuse
            for name in PER_FORWARD}


def _device_ms(fn, n=5):
    """Device busy ms per call of ``fn`` (torch.profiler, kernels summed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(device_kernels_ms(prof, n).values())


def _wall_ms_in_turns(fns, n=5):
    """Wall ms per call of each of ``fns`` (name -> fn): host clock around
    ``n`` calls and a synchronise, timed in turns (A, B, B, A) after a
    warm-up call each. Returns name -> [first turn, second turn]."""
    import torch

    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fns[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / n * 1e3)
    return times


def phase_reuse(cfg, model, card):
    """Encoder reuse and the heatmap sampler on the flagship model (128 px,
    B=2, K=20, bf16):
      a. a 20-frame video of one window (10 observed, autoreg) sampled by
         VideoSampler(encoder_reuse=3), ancestral with 50 steps: 17 full and 33
         reuse calls, 7 + 7 + 10 and 4 + 4 + 10 launches per call on
         "mma"/"bulk"; finite, the observed frames kept exactly, its relative
         L2 to the same video without reuse from the same seed printed; one
         full and one reuse call's launches read alone, and their ms per call
         (device busy; wall in turns full, reuse, reuse, full);
      b. the reuse call on the kernel path against impl="plain" on the same
         features (relative L2 <= 5e-3, as phase 4's forward);
      c. VideoSampler.sample_window_attn over one window of 8 steps: eight
         finite heatmaps of the JAX shapes, (B, K, K) and (B, 256, 256) (the
         first attention layer's 16x16 tokens), 0 + 0 + 10 launches per call.
    Returns the launch counts and routes by path."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch.config import create_diffusion
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.sampling.driver import VideoSampler

    if reuse_forward_counts(model) != (REUSE_PER_FORWARD, ATTN_PER_FORWARD):
        raise RuntimeError(f"the model's reuse and heatmap calls would launch "
                           f"{reuse_forward_counts(model)}")
    counts = {}
    B, T, C, S = FLAGSHIP_B, FLAGSHIP_K, cfg["in_channels"], cfg["image_size"]
    n_obs = 10
    video = np.random.default_rng(40).uniform(-1, 1, (B, T, C, S, S)).astype(np.float32)
    diffusion = create_diffusion(dict(cfg, timestep_respacing=REUSE_RESPACING))
    args = dict(scheme_name="autoreg", n_obs=n_obs, max_frames=FLAGSHIP_K, step_size=10)

    # a. The reuse window, and the same window without reuse from the same seed.
    sampler = VideoSampler(model, diffusion, encoder_reuse=REUSE_K)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, used = sampler.sample_video(
        video, generator=torch.Generator(device="cuda").manual_seed(41), **args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts()
    counts["reuse_window"] = (launches, routes)
    exact, _ = VideoSampler(model, diffusion).sample_video(
        video, generator=torch.Generator(device="cuda").manual_seed(41), **args)
    full_calls = sampler.model_calls - sampler.reuse_calls
    lat = slice(n_obs, T)
    rel = float(np.linalg.norm(samples[:, lat] - exact[:, lat]) / np.linalg.norm(exact[:, lat]))

    gen = torch.Generator(device="cuda").manual_seed(42)
    x, t, kw = window_inputs(cfg, "cuda", gen)
    x2 = torch.randn(x.shape, generator=gen, device="cuda")
    t2 = t - 20
    per_call = {}
    with torch.no_grad():
        ops.reset_launch_counts()
        _, _, feats = model(x, t, return_features=True, **kw)
        torch.cuda.synchronize()
        per_call["full"] = read_counts()
        ops.reset_launch_counts()
        out, _ = model(x2, t2, features=feats, **kw)
        torch.cuda.synchronize()
        per_call["reuse"] = read_counts()
        ref, _ = model(x2, t2, features=feats, impl="plain", **kw)
        calls = {"full": lambda: model(x, t, return_features=True, **kw),
                 "reuse": lambda: model(x2, t2, features=feats, **kw)}
        wall_ms = _wall_ms_in_turns(calls)
        device_ms = {name: _device_ms(fn) for name, fn in calls.items()}
    rel_plain = ((out - ref).norm() / ref.norm()).item()
    row = {"phase": "reuse_window", "card": card, "sampler": "ancestral",
           "respacing": REUSE_RESPACING, "encoder_reuse": REUSE_K, "video": [B, T, C, S, S],
           "windows": len(used), "model_calls": sampler.model_calls, "full_calls": full_calls,
           "reuse_calls": sampler.reuse_calls, "launches": launches, "routes": routes,
           "wall_s": wall, "rel_l2_latent_vs_no_reuse": rel,
           "launches_full_call": per_call["full"][0], "launches_reuse_call": per_call["reuse"][0],
           "routes_full_call": per_call["full"][1], "routes_reuse_call": per_call["reuse"][1],
           "full_call_device_ms": device_ms["full"], "reuse_call_device_ms": device_ms["reuse"],
           "full_call_wall_ms_turns": wall_ms["full"], "reuse_call_wall_ms_turns": wall_ms["reuse"],
           "reuse_rel_l2_vs_plain": rel_plain, "max_abs_reuse_out": ref.abs().max().item()}
    emit(row)
    _check_video(samples, video, n_obs, used, T)
    if (len(used), full_calls, sampler.reuse_calls) != (1, 17, 33):
        raise RuntimeError(f"expected 1 window of 17 full and 33 reuse calls, got {len(used)} "
                           f"windows, {full_calls} and {sampler.reuse_calls}")
    _check_launches(launches, routes, 1, mixed_counts(full_calls, sampler.reuse_calls))
    _check_launches(*per_call["full"], 1)
    _check_launches(*per_call["reuse"], 1, REUSE_PER_FORWARD)
    if not (torch.isfinite(out).all() and ref.abs().max().item() > 0):
        raise RuntimeError("the reuse call's output is not finite, or vacuous")
    if not rel_plain <= 5e-3:
        raise RuntimeError(f"reuse call kernel vs plain relative L2 {rel_plain} > 5e-3")

    # c. The heatmap sampler over one window.
    diff8 = create_diffusion(dict(cfg, timestep_respacing=ATTN_RESPACING))
    attn_sampler = VideoSampler(model, diff8)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, maps = attn_sampler.sample_window_attn(
        kw["x0"], kw["frame_indices"], kw["obs_mask"], kw["latent_mask"], generator=gen)
    torch.cuda.synchronize()
    attn_wall = time.perf_counter() - t0
    launches, routes = read_counts()
    counts["attn_window"] = (launches, routes)
    calls = attn_sampler.model_calls
    shapes = {tag: list(m.shape) for tag, m in maps.items()}
    emit({"phase": "attn_window", "card": card, "respacing": ATTN_RESPACING,
          "model_calls": calls, "launches": launches, "routes": routes,
          "launches_per_call": {k: v / calls for k, v in launches.items()},
          "wall_s": attn_wall, "ms_per_model_call": attn_wall / calls * 1e3, "maps": shapes,
          "map_sums": {tag: m.sum().item() for tag, m in maps.items()}})
    tokens = (S // min(model.attention_resolutions)) ** 2  # the first attention layer's
    want = {f"attn/q{q}-{kind}": [B, T, T] if kind == "temporal" else [B, tokens, tokens]
            for q in range(4) for kind in ("temporal", "spatial")}
    if shapes != want:
        raise RuntimeError(f"heatmaps {shapes} != {want}")
    if not (torch.isfinite(img).all() and all(torch.isfinite(m).all() for m in maps.values())):
        raise RuntimeError("the heatmap window or its maps are not finite")
    _check_launches(launches, routes, calls, ATTN_PER_FORWARD)
    return counts


# ---------------------------------------------------------------------------
# Phase 5c: the exported window sampler
# ---------------------------------------------------------------------------

SERVE_RESPACING = "ddim25"
SERVE_ANCESTRAL_RESPACING = "50"
SERVE_SEED = 60
SERVE_TIMED_WINDOWS = 2
# Modules a serving process must not import: the model, config, diffusion and
# sampling code, and the JAX side.
SERVE_BLOCKED = ("lfvdm_tpu_torch.models", "lfvdm_tpu_torch.config", "lfvdm_tpu_torch.sampling",
                 "lfvdm_tpu_torch.diffusion", "lfvdm_tpu", "jax", "flax")
# The serving process: imports lfvdm_tpu_torch.serving and nothing of the
# model's code (a finder refuses it), loads params.npz and sampler.pt2 from
# the directory argv[1] names, samples the window of window.npz from its
# seed (launches counted from 0 just before), then times SERVE_TIMED_WINDOWS
# more; prints one JSON line.
SERVE_CHILD = r"""
import importlib.abc, json, sys, time
BLOCKED = {blocked!r}
def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import torch
d = sys.argv[1]
t0 = time.perf_counter()
from lfvdm_tpu_torch import serving
from lfvdm_tpu_torch.ops import attention as ops
params = serving.load_params_npz(d + "/params.npz", device="cuda")
with open(d + "/sampler.pt2", "rb") as f:
    run = serving.load_window_sampler(f.read())
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
w = np.load(d + "/window.npz")
win = [torch.from_numpy(w[k]).cuda() for k in ("x0", "frame_indices", "obs_mask", "latent_mask")]
seed = int(w["seed"])
ops.reset_launch_counts()
torch.cuda.synchronize()
t0 = time.perf_counter()
out = run(params, *win, seed)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
launches = ops.launch_counts()
routes = {{n: dict(getattr(ops, n).launches_by_route)
          for n in ("spatial_attention", "skip_conv_stats")}}
np.save(d + "/served.npy", out.cpu().numpy())
device_ms, wall_ms = [], []
for _ in range({timed}):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run(params, *win, seed)
    end.record()
    torch.cuda.synchronize()
    wall_ms.append((time.perf_counter() - t0) * 1e3)
    device_ms.append(start.elapsed_time(end))
print(json.dumps({{"load_s": load_s, "first_window_s": first_s, "launches": launches,
                  "routes": routes, "steps": run.meta["num_timesteps"],
                  "window_device_ms": device_ms, "window_wall_ms": wall_ms,
                  "blocked_imported": sorted(m for m in sys.modules if blocked(m))}}))
"""


def _event_and_wall_ms_in_turns(fns, n_turns=2):
    """Per call of each of ``fns`` (name -> fn), in turns (A, B, B, A for two)
    after a warm-up call each: CUDA-event ms (from the first launch to the
    last on the stream) and host wall ms, each call ending in a synchronise."""
    import torch

    for fn in fns.values():
        fn()
    out = {name: {"device_ms": [], "wall_ms": []} for name in fns}
    order = list(fns)
    for i in range(n_turns):
        for name in (order if i % 2 == 0 else order[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fns[name]()
            end.record()
            torch.cuda.synchronize()
            out[name]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            out[name]["device_ms"].append(start.elapsed_time(end))
    return out


def phase_serve(cfg, model, card, tmp_root):
    """The exported window sampler on the flagship model (128 px, B=2, K=20,
    bf16), as a serving process runs it (lfvdm_tpu_torch.serving):
      a. export_window_sampler, DDIM (ddim25, eta 0): export seconds and the
         artifact's bytes;
      b. the artifact and params.npz served in a fresh subprocess that imports
         lfvdm_tpu_torch.serving and none of the model, config, diffusion or
         sampling modules: one window from a seed, 25 x (7 + 7 + 10) launches on
         "mma"/"bulk", load seconds, ms per window and per step (CUDA events
         and wall);
      c. the live window (VideoSampler DDIM, the same weights and initial
         noise) against the served one (relative L2 <= 5e-3), and the two
         timed in turns in this process;
      d. an ancestral artifact (respacing 50): one window, finite, the
         window's shape, 50 x (7 + 7 + 10) launches.
    Returns the launch counts and routes by path."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch import serving
    from lfvdm_tpu_torch.config import create_diffusion
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.sampling.driver import VideoSampler

    B, K, C, S = FLAGSHIP_B, FLAGSHIP_K, cfg["in_channels"], cfg["image_size"]
    params = dict(model.state_dict())
    shape = dict(batch_size=B, max_frames=K, in_channels=C, image_size=S)
    gen = torch.Generator(device="cuda").manual_seed(61)
    _, _, kw = window_inputs(cfg, "cuda", gen)
    window = [kw[k] for k in ("x0", "frame_indices", "obs_mask", "latent_mask")]
    counts = {}

    # a. Export the DDIM sampler.
    ddim = create_diffusion(dict(cfg, timestep_respacing=SERVE_RESPACING))
    t0 = time.perf_counter()
    blob = serving.export_window_sampler(model, ddim, params, use_ddim=True, eta=0.0, **shape)
    export_s = time.perf_counter() - t0

    # b. Serve it in a fresh process.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=tmp_root)
    try:
        with open(os.path.join(tmp, "sampler.pt2"), "wb") as f:
            f.write(blob)
        serving.save_params_npz(params, os.path.join(tmp, "params.npz"))
        np.savez(os.path.join(tmp, "window.npz"), seed=SERVE_SEED,
                 **{k: kw[k].cpu().numpy() for k in ("x0", "frame_indices", "obs_mask",
                                                      "latent_mask")})
        child = subprocess.run(
            [sys.executable, "-c", SERVE_CHILD.format(blocked=SERVE_BLOCKED,
                                                      timed=SERVE_TIMED_WINDOWS), tmp],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        if child.returncode != 0:
            raise RuntimeError(f"the serving process failed:\n{child.stderr[-4000:]}")
        served_row = json.loads(child.stdout.strip().splitlines()[-1])
        served = torch.from_numpy(np.load(os.path.join(tmp, "served.npy"))).cuda()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = served_row["steps"]
    counts["serve"] = (served_row["launches"], served_row["routes"])

    # c. The live window from the same seed (so the same initial noise), and
    # the served and live windows timed in turns in this process.
    live_sampler = VideoSampler(model, ddim, use_ddim=True, eta=0.0)

    def live():
        return live_sampler.sample_window(
            *window, generator=torch.Generator(device="cuda").manual_seed(SERVE_SEED))

    run = serving.load_window_sampler(blob)
    with torch.no_grad():
        ref = live()
        rel = ((served - ref).norm() / ref.norm()).item()
        turns = _event_and_wall_ms_in_turns(
            {"served": lambda: run(params, *window, SERVE_SEED), "live": live})

    # d. An ancestral artifact, one window.
    ancestral = create_diffusion(dict(cfg, timestep_respacing=SERVE_ANCESTRAL_RESPACING))
    t0 = time.perf_counter()
    blob_a = serving.export_window_sampler(model, ancestral, params, **shape)
    export_a_s = time.perf_counter() - t0
    run_a = serving.load_window_sampler(blob_a)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_a = run_a(params, *window, SERVE_SEED + 1)
    torch.cuda.synchronize()
    anc_s = time.perf_counter() - t0
    launches_a, routes_a = read_counts()
    counts["serve_ancestral"] = (launches_a, routes_a)

    per_step = {name: {k: [x / steps for x in v] for k, v in t.items()}
                for name, t in turns.items()}
    row = {"phase": "serve", "card": card, "respacing": SERVE_RESPACING, "sampler": "ddim",
           "window": [B, K, C, S, S], "export_s": export_s, "artifact_bytes": len(blob),
           "params_bytes": sum(p.numel() * p.element_size() for p in params.values()),
           "serving_process": {k: served_row[k] for k in ("load_s", "first_window_s",
                                                          "window_device_ms", "window_wall_ms",
                                                          "blocked_imported")},
           "serving_process_ms_per_step": {
               "device": [x / steps for x in served_row["window_device_ms"]],
               "wall": [x / steps for x in served_row["window_wall_ms"]]},
           "launches": served_row["launches"], "routes": served_row["routes"], "steps": steps,
           "served_vs_live_rel_l2": rel, "in_turns_ms_per_window": turns,
           "in_turns_ms_per_step": per_step, "max_abs_live": ref.abs().max().item()}
    emit(row)
    emit({"phase": "serve_ancestral", "card": card, "respacing": SERVE_ANCESTRAL_RESPACING,
          "export_s": export_a_s, "artifact_bytes": len(blob_a), "window_s": anc_s,
          "steps": run_a.meta["num_timesteps"], "launches": launches_a, "routes": routes_a,
          "max_abs": out_a.abs().max().item()})
    if served_row["blocked_imported"]:
        raise RuntimeError(f"the serving process imported {served_row['blocked_imported']}")
    if steps != 25 or run_a.meta["num_timesteps"] != 50:
        raise RuntimeError(f"the artifacts run {steps} and {run_a.meta['num_timesteps']} steps, "
                           "not 25 and 50")
    _check_launches(served_row["launches"], served_row["routes"], steps)
    _check_launches(launches_a, routes_a, 50)
    if not (torch.isfinite(served).all() and ref.abs().max().item() > 0):
        raise RuntimeError("the served window is not finite, or the live one vacuous")
    if not rel <= 5e-3:
        raise RuntimeError(f"served vs live window relative L2 {rel} > 5e-3")
    if tuple(out_a.shape) != (B, K, C, S, S) or not torch.isfinite(out_a).all():
        raise RuntimeError(f"the ancestral window is {tuple(out_a.shape)} or not finite")
    return counts


def phase_serve_params(ckpt_dir, card):
    """e. of phase 5c, on phase 6's run directory: export_params writes the
    EMA weights as a flax .msgpack of the JAX tree, and video_sample's loader
    reads it back; its U-Net output equals the run directory's, bitwise."""
    import torch

    from lfvdm_tpu_torch.config import flagship_config
    from lfvdm_tpu_torch.scripts import export_params, video_sample

    t0 = time.perf_counter()
    path = export_params.main([ckpt_dir, "--ema_rate", "0.9999"])
    export_s = time.perf_counter() - t0
    load = dict(use_ddim=True, timestep_respacing=SERVE_RESPACING, device="cuda")
    from_msgpack, _, _ = video_sample.load_model_from_checkpoint(path, **load)
    from_run, _, _ = video_sample.load_model_from_checkpoint(ckpt_dir, ema_rate="0.9999", **load)
    x, t, kw = window_inputs(flagship_config(), "cuda",
                             torch.Generator(device="cuda").manual_seed(62))
    with torch.no_grad():
        a, _ = from_msgpack.eval()(x, t, **kw)
        b, _ = from_run.eval()(x, t, **kw)
    equal = bool(torch.equal(a, b))
    emit({"phase": "serve_export_params", "card": card, "msgpack": os.path.basename(path),
          "msgpack_bytes": os.path.getsize(path), "export_s": export_s,
          "unet_outputs_bitwise_equal": equal, "max_abs_out": b.abs().max().item()})
    if not equal:
        raise RuntimeError("the U-Net from the exported .msgpack differs from the run "
                           f"directory's (max |diff| {(a - b).abs().max().item()})")


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
    from lfvdm_tpu_torch.data.datasets import batch_generator, load_data
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
    with timed_draws(loop) as batch_s:  # the host batch time inside each step, prefetching
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

    # The host's share of a step without the prefetch: drawing, masking and
    # uploading one batch, three times back to back, from the synchronous
    # generator over the same (rendered) videos.
    videos = load_data("synthetic", batch_size=FLAGSHIP_B, image_size=cfg["image_size"],
                       return_dataset=True)
    for i in range(len(videos)):
        videos[i]
    prefetching, loop.data = loop.data, batch_generator(videos, FLAGSHIP_B)
    prep_ms = _host_batch_ms_back_to_back(loop, 3)
    loop.data = prefetching

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
           "peak_mem_gib": peak / 2**30, "host_batch_prep_ms": prep_ms,
           "host_batch_ms_in_step_prefetch": [x * 1e3 for x in batch_s],
           "losses": losses, "param_max_change": moved,
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
# Phase 7b: data parallelism and remat (lfvdm_tpu_torch/parallel)
# ---------------------------------------------------------------------------

PARALLEL_DROPOUT = 0.1  # so that the rematerialised blocks' masks matter
PARALLEL_STEPS = 2  # timed steps per loop, after one warm-up step
PARALLEL_LR = 1e-4
BATCH_KEYS = ("x0", "frame_indices", "obs_mask", "latent_mask")
# Launches per train step with use_checkpoint: each block's forward runs
# again in the backward pass.
REMAT_PER_STEP = {name: 2 * n for name, n in PER_FORWARD.items()}

# One rank of phase 7b c: joins a gloo group of two on the one card, takes
# one process's flagship step on both rows unwrapped (the reference, no
# collective), then one step on its own row under DDP and under FSDP2, and
# sums its parameters' and Adam first moments' squared distances to the
# reference over what it holds: DDP's full replica on rank 0 alone, FSDP2's
# shards on each rank where they lie (DTensor's full_tensor() over gloo on
# CUDA tensors crashed the process in torch 2.11), its replicated
# parameters on rank 0.
TWO_RANK_CHILD = r"""
import datetime, faulthandler, json, os, sys, time
faulthandler.enable()
job = json.loads(sys.argv[1])
sys.path.insert(0, job["root"])
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="tcp://localhost:%d" % job["port"], rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=300))
from lfvdm_tpu_torch.config import create_diffusion, create_model_and_diffusion
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.training.train_loop import (TrainLoop, init_train_state, make_optimizer,
                                                 train_step)
inputs = {k: v.cuda() for k, v in torch.load(job["inputs"]).items()}
diffusion = create_diffusion(dict(job["cfg"], timestep_respacing=""))
keys = ("x0", "frame_indices", "obs_mask", "latent_mask")

def model():
    m, _ = create_model_and_diffusion(job["cfg"], device="cuda")
    m.load_state_dict(torch.load(job["params"]))
    return m

def step(state, rows):
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = train_step(state, {k: inputs[k][rows] for k in keys}, inputs["t"][rows],
                   inputs["w"][rows], diffusion=diffusion, noise=inputs["noise"][rows])
    torch.cuda.synchronize()
    return {"ms": (time.perf_counter() - t0) * 1e3, "launches": ops.launch_counts(),
            "routes": {n: dict(getattr(ops, n).launches_by_route)
                       for n in ("spatial_attention", "skip_conv_stats")},
            "skipped": m["skipped_nonfinite"].item(), "loss": m["loss"].tolist()}

def squared_distances(state, want):
    sums = {"params": [0.0, 0.0], "exp_avg": [0.0, 0.0]}
    for name, p in state.named_params():
        held = {"params": p.detach(), "exp_avg": state.optimizer.state[p]["exp_avg"]}
        for key, got in held.items():
            ref = want[key][name]
            if isinstance(got, DTensor):
                (dim,) = [pl.dim for pl in got.placements if isinstance(pl, Shard)]
                mesh = got.device_mesh
                ref = ref.chunk(mesh.size(1), dim)[mesh.get_local_rank(1)]
                got = got.to_local()
            elif rank != 0:
                continue
            sums[key][0] += (got.float() - ref.float()).square().sum().item()
            sums[key][1] += ref.float().square().sum().item()
    return sums

m = model()
opt, sched = make_optimizer(m.parameters(), job["lr"], 0.0)
one = init_train_state(m, opt, sched, [0.9999])
out = {"rank": rank, "one_process": step(one, slice(0, 2))}
ref = one.state_dict()
want = {"params": ref["params"], "exp_avg": ref["adam"]["exp_avg"]}
del m, opt, one
for kind, fsdp in (("ddp", 1), ("fsdp", 2)):
    loop = TrainLoop(model=model(), diffusion=diffusion, data=iter(()), batch_size=1,
                     max_frames=job["K"], lr=job["lr"], ema_rate="0.9999", fsdp=fsdp,
                     checkpoint_dir=job["tmp"])
    out[kind] = step(loop.state, slice(rank, rank + 1))
    out[kind]["wrapper"] = type(loop.model).__name__
    out[kind]["squared_distances"] = squared_distances(loop.state, want)
    loop = None
    torch.cuda.empty_cache()
    dist.barrier()
print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flagship_step_inputs(cfg, B, seed, device="cuda"):
    """One train step's batch (B rows of seeded 128 px frames, masks drawn as
    training draws them), timesteps, weights and noise, on ``device``."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch.training.masks import sample_training_batch

    rng = np.random.default_rng(seed)
    C, S = cfg["in_channels"], cfg["image_size"]
    video = rng.uniform(-1, 1, (B, 60, C, S, S)).astype(np.float32)
    x0, fi, obs, lat = sample_training_batch(rng, video, FLAGSHIP_K, batch2=video[::-1])
    t = rng.integers(0, cfg["diffusion_steps"], B)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    return {"x0": torch.tensor(x0, device=device),
            "frame_indices": torch.tensor(fi, dtype=torch.int64, device=device),
            "obs_mask": torch.tensor(obs, device=device),
            "latent_mask": torch.tensor(lat, device=device),
            "t": torch.tensor(t, device=device), "w": torch.ones(B, device=device),
            "noise": torch.tensor(noise, device=device)}


def _seeded_flagship(**config):
    """The flagship U-Net (training's 1000-step diffusion) with phase 4's
    seeded weights, zero layers at 1/10 scale: every such call gives the same
    weights."""
    import torch

    from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config

    cfg = dict(flagship_config(), **config)
    model, diffusion = create_model_and_diffusion(cfg, device="cuda", seed=0)
    randomize_zero_modules(model, torch.Generator().manual_seed(1))
    return cfg, model, diffusion


def _rel_l2_tensors(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_parallel(ckpt_root, card):
    """a. remat, b. DDP and FSDP2 in a group of one rank on NCCL, c. two gloo
    ranks on the one card, d. sampling over two replicas. Returns the launch
    counts and routes of each path."""
    t0 = time.perf_counter()
    counts = {}
    counts.update(_parallel_remat(card))
    counts.update(_parallel_group_of_one(ckpt_root, card))
    counts.update(_parallel_two_ranks(ckpt_root, card))
    counts.update(_parallel_sample(card))
    emit({"phase": "parallel", "wall_s": time.perf_counter() - t0})
    return counts


def _parallel_remat(card):
    """One train step with use_checkpoint and one without, the same weights,
    batch, noise and dropout masks (p = 0.1): loss and gradients within
    5e-3 in bf16 and 1e-5 in f32 (TF32 off); peak memory, ms per step and
    launches per step (14 + 14 + 20 with remat) both ways."""
    import torch

    paths = {}
    for dtype, band in (("bfloat16", 5e-3), ("float32", 1e-5)):
        B = FLAGSHIP_B
        while True:
            try:
                rows = _remat_rows(dtype, B, paths)
                break
            except torch.cuda.OutOfMemoryError:
                if B == 1:
                    raise
                B = 1
                torch.cuda.empty_cache()
        plain, remat = rows
        row = {"phase": "parallel_remat", "dtype": dtype, "B": B, "K": FLAGSHIP_K,
               "dropout": PARALLEL_DROPOUT,
               "loss_rel_err": abs(remat["loss"] - plain["loss"]) / abs(plain["loss"]),
               "grad_rel_l2": _rel_l2_tensors(remat.pop("grads"), plain.pop("grads")),
               "plain": plain, "remat": remat, "nvidia_smi": card}
        emit(row)
        if not (row["loss_rel_err"] <= band and row["grad_rel_l2"] <= band):
            raise RuntimeError(f"remat step ({dtype}) differs from the plain one beyond {band}: "
                               f"loss {row['loss_rel_err']}, gradients {row['grad_rel_l2']}")
        if dtype == "bfloat16" and not remat["peak_mem_gib"] < plain["peak_mem_gib"]:
            raise RuntimeError("remat did not lower the step's peak memory")
    return paths


def _remat_rows(dtype, B, paths):
    import torch

    from lfvdm_tpu_torch.models.unet import set_dropout_generator
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.training.train_loop import backward_microbatches

    rows = []
    for remat in (False, True):
        cfg, model, diffusion = _seeded_flagship(compute_dtype=dtype, dropout=PARALLEL_DROPOUT,
                                                 use_checkpoint=remat)
        x = _flagship_step_inputs(cfg, B, seed=70)
        batch = {k: x[k] for k in BATCH_KEYS}
        gen = torch.Generator(device="cuda")
        set_dropout_generator(model, gen)
        model.train()

        def step():
            gen.manual_seed(71)
            model.zero_grad(set_to_none=True)
            return backward_microbatches(model, diffusion, batch, x["t"], x["w"],
                                         noise=x["noise"])[0]

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(PARALLEL_STEPS):
            loss = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / PARALLEL_STEPS * 1e3
        launches, routes = read_counts()
        if dtype == "bfloat16":
            _check_launches(launches, routes, PARALLEL_STEPS,
                            per_forward=REMAT_PER_STEP if remat else PER_FORWARD)
            paths["parallel_remat" if remat else "parallel_no_remat"] = (launches, routes)
        rows.append({"use_checkpoint": remat, "loss": loss.item(), "ms_per_step": ms,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches_per_step": {k: v / PARALLEL_STEPS for k, v in launches.items()},
                     "grads": torch.cat([p.grad.flatten().float() for p in model.parameters()])})
        del model
        torch.cuda.empty_cache()
    return rows


def _parallel_group_of_one(ckpt_root, card):
    """A group of one rank on NCCL: TrainLoop unwrapped, through DDP and
    through FSDP2 on a (1, 1) mesh (its all-gathers and reduce-scatters run,
    over one rank), the same weights and batches: parameters and Adam's
    first moment after the steps against the unwrapped loop's, ms per step;
    the FSDP2 run saved and resumed unwrapped, bitwise."""
    import torch
    import torch.distributed as dist

    from lfvdm_tpu_torch.config import flagship_config
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.parallel import mesh as mesh_lib
    from lfvdm_tpu_torch.parallel import sharding
    from lfvdm_tpu_torch.training.train_loop import TrainLoop, train_step

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=ckpt_root)
    paths, states, row = {}, {}, {"phase": "parallel_group_of_one", "backend": "nccl",
                                  "world": 1, "B": FLAGSHIP_B, "K": FLAGSHIP_K,
                                  "steps": PARALLEL_STEPS, "nvidia_smi": card}
    try:
        mesh = mesh_lib.make_mesh(fsdp=1, device_type="cuda")
        row["mesh"] = list(mesh.shape)
        steps = [_flagship_step_inputs(flagship_config(), FLAGSHIP_B, seed=80 + i)
                 for i in range(1 + PARALLEL_STEPS)]

        def new_loop(kind, run="", resume=False):
            _, model, diffusion = _seeded_flagship()
            if kind == "fsdp":
                model = sharding.shard_model(model, mesh)
            return TrainLoop(model=model, diffusion=diffusion, data=iter(()),
                             batch_size=FLAGSHIP_B, max_frames=FLAGSHIP_K, lr=PARALLEL_LR,
                             ema_rate="0.9999", checkpoint_dir=os.path.join(tmp, run or kind),
                             mesh=None if kind == "plain" else mesh, resume=resume)

        for kind in ("plain", "ddp", "fsdp"):
            loop = new_loop(kind)
            ms = []
            for i, x in enumerate(steps):
                if i == 1:
                    ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = train_step(loop.state, {k: x[k] for k in BATCH_KEYS}, x["t"], x["w"],
                               diffusion=loop.diffusion, noise=x["noise"])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if m["skipped_nonfinite"].item():
                    raise RuntimeError(f"{kind}: a non-finite step")
            launches, routes = read_counts()
            _check_launches(launches, routes, PARALLEL_STEPS)
            paths[f"parallel_{kind}"] = (launches, routes)
            state = loop.state.state_dict()
            states[kind] = state
            row[kind] = {"wrapper": type(loop.model).__name__, "ms_per_step": ms[1:],
                         "first_step_ms": ms[0], "loss": m["loss"].tolist()}
            if kind == "fsdp":
                loop.save()
                resumed = new_loop("plain", run="fsdp", resume=True)
                row["fsdp_resumed_unwrapped_bitwise"] = _states_equal(
                    state, resumed.state.state_dict())
                del resumed
            del loop
            torch.cuda.empty_cache()
        want = states["plain"]
        for kind in ("ddp", "fsdp"):
            got = states[kind]
            p = torch.cat([(got["params"][k] - want["params"][k]).flatten() for k in want["params"]])
            row[kind]["params_max_abs"] = p.abs().max().item()
            row[kind]["params_bitwise"] = bool(p.abs().max().item() == 0)
            row[kind]["params_rel_l2"] = (p.norm() / torch.cat(
                [v.flatten() for v in want["params"].values()]).norm()).item()
            row[kind]["grad_rel_l2"] = _rel_l2_tensors(
                torch.cat([v.flatten() for v in got["adam"]["exp_avg"].values()]),
                torch.cat([v.flatten() for v in want["adam"]["exp_avg"].values()]))
            row[kind]["ms_per_step_vs_plain"] = (sum(row[kind]["ms_per_step"])
                                                 / sum(row["plain"]["ms_per_step"]))
        emit(row)
        for kind in ("ddp", "fsdp"):
            if not (row[kind]["params_rel_l2"] <= 5e-3 and row[kind]["grad_rel_l2"] <= 5e-3):
                raise RuntimeError(f"{kind} in a group of one differs from the unwrapped loop: "
                                   f"{row[kind]}")
        if not row["fsdp_resumed_unwrapped_bitwise"]:
            raise RuntimeError("the FSDP2 run resumed unwrapped differs from the saved state")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    return paths


def _parallel_two_ranks(ckpt_root, card):
    """Two processes on the one card in a gloo group (NCCL refuses two ranks
    on one device), B=1 each: DDP's and FSDP2's (fsdp 2) step against one
    process's B=2 step on the same rows and noise (bf16 band), parameters
    and Adam's first moment; 7 + 7 + 10 launches per rank and step."""
    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_", dir=ckpt_root)
    paths = {}
    try:
        cfg, model, _ = _seeded_flagship()
        torch.save(model.state_dict(), os.path.join(tmp, "params.pt"))
        del model
        x = _flagship_step_inputs(cfg, FLAGSHIP_B, seed=90, device="cpu")
        torch.save(x, os.path.join(tmp, "inputs.pt"))
        torch.cuda.empty_cache()
        job = dict(root=os.path.dirname(os.path.abspath(__file__)), port=_free_port(), cfg=cfg,
                   K=FLAGSHIP_K, lr=PARALLEL_LR, tmp=tmp, params=os.path.join(tmp, "params.pt"),
                   inputs=os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", TWO_RANK_CHILD, json.dumps(job)],
                                  env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                                           LOCAL_RANK="0"),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=600)
                line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
                if p.returncode != 0 or not line:
                    raise RuntimeError(f"a rank failed ({p.returncode}): {out[-2000:]}\n"
                                       f"{err[-6000:]}")
                results.append(json.loads(line[0][len("RESULT "):]))
        finally:
            for p in procs:
                p.kill()
                p.wait(timeout=30)
        row = {"phase": "parallel_two_ranks", "backend": "gloo", "ranks_on_one_card": 2,
               "B_per_rank": 1, "wall_s": time.perf_counter() - t0, "ranks": results,
               "nvidia_smi": card}
        for kind in ("ddp", "fsdp"):
            for key in ("params", "exp_avg"):  # Adam's first moment: 0.1 x the gradient
                d2, ref2 = (sum(r[kind]["squared_distances"][key][i] for r in results)
                            for i in (0, 1))
                row[f"{kind}_{key}_rel_l2"] = math.sqrt(d2 / ref2)
        emit(row)
        for kind in ("ddp", "fsdp"):
            if not (row[f"{kind}_params_rel_l2"] <= 5e-3 and row[f"{kind}_exp_avg_rel_l2"] <= 5e-3):
                raise RuntimeError(f"two {kind} ranks differ from one process's step: {row}")
            for r in results:
                if r[kind]["skipped"]:
                    raise RuntimeError(f"rank {r['rank']} {kind}: a non-finite step")
                _check_launches(r[kind]["launches"], r[kind]["routes"], 1)
                paths[f"parallel_two_ranks_{kind}_rank{r['rank']}"] = (r[kind]["launches"],
                                                                       r[kind]["routes"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


def _parallel_sample(card):
    """VideoSampler(devices=[cuda:0, cuda:0]): a DDIM window (ddim25, B=2)
    over two replicas on the one card against the one-device window (within
    5e-3), both timed in turns; 7 + 7 + 10 launches per replica call."""
    import torch

    from lfvdm_tpu_torch.config import create_diffusion
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.sampling.driver import VideoSampler

    cfg, model, _ = flagship_model("cuda")
    diff = create_diffusion(dict(cfg, timestep_respacing="ddim25"))
    _, _, kw = window_inputs(cfg, "cuda", torch.Generator(device="cuda").manual_seed(95))
    window = (kw["x0"], kw["frame_indices"], kw["obs_mask"], kw["latent_mask"])
    one = VideoSampler(model, diff, use_ddim=True)
    two = VideoSampler(model, diff, use_ddim=True,
                       devices=[torch.device("cuda", 0), torch.device("cuda", 0)])

    def run(sampler):
        return sampler.sample_window(*window,
                                     generator=torch.Generator(device="cuda").manual_seed(96))

    ops.reset_launch_counts()
    two.model_calls = 0
    got = run(two)
    torch.cuda.synchronize()
    launches, routes = read_counts()
    calls = two.model_calls
    want = run(one)
    times = _wall_ms_in_turns({"one_device": lambda: run(one), "two_replicas": lambda: run(two)},
                              n=1)
    row = {"phase": "parallel_sample", "sampler": "ddim", "respacing": "ddim25",
           "B": FLAGSHIP_B, "devices": ["cuda:0", "cuda:0"], "replica_calls": calls,
           "launches": launches, "routes": routes,
           "rel_l2": _rel_l2_tensors(got, want), "bitwise": bool(torch.equal(got, want)),
           "ms_per_window_in_turns": times, "nvidia_smi": card}
    emit(row)
    if not (torch.isfinite(got).all() and row["rel_l2"] <= 5e-3):
        raise RuntimeError(f"the window over two replicas differs from one device's: {row}")
    _check_launches(launches, routes, calls)
    if calls != 2 * 25:
        raise RuntimeError(f"expected 2 x 25 replica calls, got {calls}")
    return {"parallel_sample": (launches, routes)}


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
# Phase 9: the entry points — the video_sample and video_train CLIs
# ---------------------------------------------------------------------------

CLI_DATASET = "carla_no_traffic"
CLI_VIDEO_T, CLI_TRAIN_VIDEOS, CLI_TEST_VIDEOS = 100, 8, 4
CLI_SAMPLE = dict(T=60, n_obs=10, max_frames=FLAGSHIP_K, batch_size=FLAGSHIP_B,
                  scheme="hierarchy-2", respacing="ddim25")
CLI_TRAIN_STEPS = 4
CLI_LOADER_BATCHES = 8
# The keys of the reference's own config (its script_util defaults): the
# port's and the TPU package's extra model keys are not in a reference .pt.
REFERENCE_ONLY_DROPS = ("compute_dtype", "fused_skip_conv", "wavelet_levels")


def write_carla_fixture(data_root, seed=30, size=128, T=CLI_VIDEO_T, n_train=CLI_TRAIN_VIDEOS,
                        n_test=CLI_TEST_VIDEOS, npy=True):
    """The CARLA layout under ``data_root`` (the registry's
    datasets/carla/no-traffic): video_{train,test}.csv and uint8 (T, size,
    size, 3) ``.pt`` videos drawn from ``seed``, with ``.npy`` siblings for
    the train split (the native loader's files). Returns the directory."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch.data.datasets import video_data_paths_dict

    root = os.path.join(data_root, video_data_paths_dict[CLI_DATASET])
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    splits = {"train": [], "test": []}
    for i in range(n_train + n_test):
        split = "train" if i < n_train else "test"
        name = f"video_{i:05d}.pt"
        video = rng.integers(0, 256, (T, size, size, 3), dtype=np.uint8)
        torch.save(torch.from_numpy(video), os.path.join(root, name))
        if npy and split == "train":
            np.save(os.path.join(root, name[:-3] + ".npy"), video)
        splits[split].append(name)
    for split, names in splits.items():
        with open(os.path.join(root, f"video_{split}.csv"), "w") as f:
            f.write("".join(f"videos/{n}\n" for n in names))
    return root


def write_reference_checkpoint(path, model, cfg, **extra):
    """``model``'s weights as a reference-format ``.pt``: {"state_dict",
    "config"} with the reference's config keys (no compute dtype: the
    reference's bf16 torso default)."""
    import torch

    from lfvdm_tpu_torch.config import model_and_diffusion_defaults

    config = {k: cfg.get(k, v) for k, v in model_and_diffusion_defaults().items()
              if k not in REFERENCE_ONLY_DROPS}
    config.update(extra)
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "config": config}, path)
    return config


def check_sample_files(written, dataset, indices, n_obs, shape):
    """Each sample file a uint8 video of ``shape`` whose first ``n_obs``
    frames are the test video's, through the CLI's own float -> uint8 map,
    exactly."""
    import numpy as np

    from lfvdm_tpu_torch.scripts.video_sample import to_uint8

    if len(written) != len(indices):
        raise RuntimeError(f"{len(written)} sample files written, expected {len(indices)}")
    for path, i in zip(written, indices):
        video = np.load(path)
        if video.dtype != np.uint8 or video.shape != tuple(shape):
            raise RuntimeError(f"{path}: {video.dtype} {video.shape}, expected uint8 {shape}")
        if not np.array_equal(video[:n_obs], to_uint8(dataset[i][:n_obs])):
            raise RuntimeError(f"{path}: the observed frames were not kept")


def cli_sample_argv(checkpoint, eval_dir):
    """video_sample's command line: a 60-frame hierarchy-2 video per test
    video, 10 observed, windows of K = 20, DDIM with 25 steps, B = 2."""
    sp = CLI_SAMPLE
    return [checkpoint, "--dataset", CLI_DATASET, "--T", str(sp["T"]),
            "--n_obs", str(sp["n_obs"]), "--max_frames", str(sp["max_frames"]),
            "--batch_size", str(sp["batch_size"]), "--sampling_scheme", sp["scheme"],
            "--use_ddim", "True", "--timestep_respacing", sp["respacing"], "--eval_dir", eval_dir]


def cli_train_argv(run_dir):
    """video_train's command line: these flags and the dataset give
    ``config.flagship_config()``; 4 steps, saved at the 4th, logged each."""
    return ["--dataset", CLI_DATASET, "--T", str(CLI_VIDEO_T), "--num_res_blocks", "1",
            "--batch_size", str(FLAGSHIP_B), "--max_frames", str(FLAGSHIP_K),
            "--max_steps", str(CLI_TRAIN_STEPS), "--save_interval", str(CLI_TRAIN_STEPS),
            "--sample_interval", str(CLI_TRAIN_STEPS), "--log_interval", "1",
            "--checkpoint_dir", run_dir]


def pil_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def _timed_batches(gen, n, warmup=2):
    for _ in range(warmup):
        next(gen)
    t0 = time.perf_counter()
    for _ in range(n):
        next(gen)
    return (time.perf_counter() - t0) / n * 1e3


def phase_cli(ckpt_root, card):
    """Both CLIs' ``main(argv)`` at the flagship's full width on a seeded
    CARLA-layout fixture: sampling from a reference ``.pt`` (hierarchy-2,
    DDIM 25), idempotent on a second run; 4 training steps served by the
    native loader, the vis sampler on the trained loop, and sampling from the
    run directory's raw weights; then the loaders' cost. Every model call
    launches 7 + 7 + 10 kernels on the "mma" and "bulk" routes. Returns the
    launch counts and routes by path."""
    import types

    import numpy as np
    import torch

    from lfvdm_tpu_torch.config import create_diffusion, flagship_config
    from lfvdm_tpu_torch.data import datasets as data
    from lfvdm_tpu_torch.data.native_loader import native_loader_available, native_loader_error
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.scripts import video_sample, video_train
    from lfvdm_tpu_torch.training.vis_sampling import make_sample_fn

    if not native_loader_available():
        raise RuntimeError(f"the native loader did not build: {native_loader_error()}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=ckpt_root)
    saved_root = os.environ.get("DATA_ROOT")
    os.environ["DATA_ROOT"] = os.path.join(tmp, "data")
    counts = {}
    try:
        t0 = time.perf_counter()
        write_carla_fixture(os.environ["DATA_ROOT"])
        cfg, model, _ = flagship_model("cuda")
        ckpt = os.path.join(tmp, "flagship.pt")
        write_reference_checkpoint(ckpt, model, cfg, dataset=CLI_DATASET,
                                   max_frames=FLAGSHIP_K, T=CLI_VIDEO_T)
        del model
        emit({"phase": "cli_fixtures", "card": card, "s": time.perf_counter() - t0,
              "videos": [CLI_TRAIN_VIDEOS, CLI_TEST_VIDEOS], "video": [CLI_VIDEO_T, 128, 128, 3]})

        # Sampling from the reference .pt.
        sp = CLI_SAMPLE
        argv = cli_sample_argv(ckpt, os.path.join(tmp, "eval"))
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        run = video_sample.main(argv)
        torch.cuda.synchronize()
        launches, routes = read_counts()
        counts["cli_sample"] = (launches, routes)
        calls, videos = run["model_calls"], len(run["written"])
        test = data.get_test_dataset(CLI_DATASET, T=sp["T"])
        again = video_sample.main(argv)
        row = {"phase": "cli_sample", "card": card, "scheme": sp["scheme"],
               "respacing": sp["respacing"], "videos": videos, "T": sp["T"],
               "model_calls": calls, "sampling_s": run["sampling_s"],
               "s_per_video": run["sampling_s"] / videos,
               "ms_per_model_call": run["sampling_s"] / calls * 1e3,
               "launches": launches, "routes": routes,
               "second_run_written": len(again["written"])}
        emit(row)
        check_sample_files(run["written"], test, range(sp["batch_size"]), sp["n_obs"],
                           (sp["T"], 3, 128, 128))
        _check_launches(launches, routes, calls)
        if again["written"] or again["model_calls"]:
            raise RuntimeError("the second sampling run wrote files")
        counts.update(_cli_reuse_and_adaptive(ckpt, tmp, card))

        # Training: the flagship config from the flags.
        run_dir = os.path.join(tmp, "run")
        argv = cli_train_argv(run_dir)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop = video_train.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches, routes = read_counts()
        counts["cli_train"] = (launches, routes)
        served = {"source": loop.data.source, "batches": loop.data.served}
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        flagship = {k: loop.config[k] for k in flagship_config()}
        step_dir = os.path.join(run_dir, str(CLI_TRAIN_STEPS))
        files = sorted(os.listdir(step_dir)) if os.path.isdir(step_dir) else []
        emit({"phase": "cli_train", "card": card, "steps": CLI_TRAIN_STEPS, "wall_s": train_s,
              "batches_served": served, "losses": losses, "config": flagship,
              "launches": launches, "routes": routes, "run_dir_files": files})
        if flagship != flagship_config():
            raise RuntimeError(f"the flags gave {flagship}, not the flagship config")
        if served["source"] != "native" or served["batches"] < 2 * CLI_TRAIN_STEPS:
            raise RuntimeError(f"training was not served by the native loader: {served}")
        if len(losses) != CLI_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"training losses {losses}")
        if not os.path.exists(os.path.join(run_dir, "config.json")) or files != [
                "ema_0.9999.pt", "params.pt", "train_state.pt"]:
            raise RuntimeError(f"run directory {run_dir} holds {files}")
        _check_launches(launches, routes, CLI_TRAIN_STEPS)

        # The vis sampler on the trained loop (the 4-step run never reaches
        # its sample interval), with a 25-step schedule instead of the
        # training one's 1000.
        gifs = pil_available()
        vis_batch = np.stack([test[i] for i in range(FLAGSHIP_B)])  # T > K frames
        view = types.SimpleNamespace(
            model=loop.model, diffusion=create_diffusion(dict(loop.config, timestep_respacing="25")),
            state=loop.state, max_frames=FLAGSHIP_K, codec=loop.codec, device=loop.device,
            step=loop.step, ema_params=loop.ema_params, sampling_model=loop.sampling_model)
        ops.reset_launch_counts()
        vids = make_sample_fn(vis_batch, out_dir=os.path.join(run_dir, "vis") if gifs else None,
                              seed=0)(view)
        torch.cuda.synchronize()
        launches, routes = read_counts()
        counts["cli_vis"] = (launches, routes)
        written = sorted(os.listdir(os.path.join(run_dir, "vis"))) if gifs else []
        emit({"phase": "cli_vis", "card": card, "pil": gifs, "gifs": written,
              "videos": list(vids.shape), "launches": launches, "routes": routes,
              "note": None if gifs else "PIL is absent: make_sample_fn ran with out_dir=None"})
        _check_launches(launches, routes, 25)
        if gifs and len(written) != FLAGSHIP_B:
            raise RuntimeError(f"vis sampling wrote {written}")

        # Sampling from the new run directory's raw weights, one window.
        argv = [run_dir, "--ema_rate", "raw", "--T", "20", "--n_obs", "10",
                "--max_frames", str(FLAGSHIP_K), "--batch_size", str(FLAGSHIP_B),
                "--sampling_scheme", "autoreg", "--use_ddim", "True",
                "--timestep_respacing", "ddim10", "--eval_dir", os.path.join(tmp, "eval_run")]
        ops.reset_launch_counts()
        run2 = video_sample.main(argv)
        torch.cuda.synchronize()
        launches, routes = read_counts()
        counts["cli_run_dir_sample"] = (launches, routes)
        emit({"phase": "cli_run_dir_sample", "card": card, "model_calls": run2["model_calls"],
              "sampling_s": run2["sampling_s"], "written": len(run2["written"]),
              "launches": launches, "routes": routes})
        check_sample_files(run2["written"], data.get_test_dataset(CLI_DATASET, T=20),
                           range(FLAGSHIP_B), 10, (20, 3, 128, 128))
        _check_launches(launches, routes, run2["model_calls"])

        emit(_loader_costs(loop, card))
        del loop
    finally:
        if saved_root is None:
            os.environ.pop("DATA_ROOT", None)
        else:
            os.environ["DATA_ROOT"] = saved_root
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts


CLI_REUSE = dict(T=40, n_obs=10, scheme="autoreg", respacing=REUSE_RESPACING)
CLI_ADAPTIVE = dict(T=40, n_obs=10, scheme="adaptive-autoreg", respacing="ddim25")


def _cli_reuse_and_adaptive(ckpt, tmp, card):
    """Phase 5b d: video_sample on the fixture's reference .pt with
    ``--encoder_reuse 3`` (autoreg, 40 frames, 10 observed, 50 ancestral
    steps: 3 windows of 17 full and 33 reuse calls) and with
    ``--sampling_scheme adaptive-autoreg`` (40 frames, DDIM 25) on the LPIPS
    embedder on the card; each writes uint8 videos whose observed frames are
    the test videos'. Then the embedder's ms per batch of frames (the
    scheme embeds the whole (B·T)-frame buffer once per window)."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch.data import datasets as data
    from lfvdm_tpu_torch.evals.lpips import default_lpips_embedder
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.scripts import video_sample

    counts = {}
    for name, sp, extra in (("cli_reuse", CLI_REUSE, ["--encoder_reuse", str(REUSE_K)]),
                            ("cli_adaptive", CLI_ADAPTIVE, ["--use_ddim", "True"])):
        argv = [ckpt, "--dataset", CLI_DATASET, "--T", str(sp["T"]), "--n_obs", str(sp["n_obs"]),
                "--max_frames", str(FLAGSHIP_K), "--batch_size", str(FLAGSHIP_B),
                "--sampling_scheme", sp["scheme"], "--timestep_respacing", sp["respacing"],
                "--eval_dir", os.path.join(tmp, name)] + extra
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        run = video_sample.main(argv)
        torch.cuda.synchronize()
        launches, routes = read_counts()
        counts[name] = (launches, routes)
        calls, reuse = run["model_calls"], run["reuse_calls"]
        emit({"phase": name, "card": card, "scheme": sp["scheme"], "respacing": sp["respacing"],
              "args": extra, "videos": len(run["written"]), "T": sp["T"], "model_calls": calls,
              "reuse_calls": reuse, "sampling_s": run["sampling_s"],
              "ms_per_model_call": run["sampling_s"] / calls * 1e3,
              "launches": launches, "routes": routes})
        check_sample_files(run["written"], data.get_test_dataset(CLI_DATASET, T=sp["T"]),
                           range(FLAGSHIP_B), sp["n_obs"], (sp["T"], 3, 128, 128))
        want_reuse = 3 * 33 if name == "cli_reuse" else 0
        if (calls, reuse) != (3 * (50 if name == "cli_reuse" else 25), want_reuse):
            raise RuntimeError(f"{name}: {calls} model calls, {reuse} reuse calls")
        _check_launches(launches, routes, 1, mixed_counts(calls - reuse, reuse))

    emb = default_lpips_embedder("cuda")
    frames = np.random.default_rng(43).uniform(
        -1, 1, (FLAGSHIP_B * CLI_ADAPTIVE["T"], 3, 128, 128)).astype(np.float32)
    x = torch.as_tensor(frames, device="cuda")
    with torch.no_grad():
        device_ms = _device_ms(lambda: emb.module(x))
    emb(frames)
    t0 = time.perf_counter()
    for _ in range(5):
        e = emb(frames)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    emit({"phase": "lpips_embedder", "card": card, "frames": list(frames.shape),
          "pretrained": emb.pretrained, "embedding": list(e.shape),
          "ms_per_batch": host_ms, "device_ms_per_batch": device_ms,
          "note": "ms_per_batch: numpy in, numpy out, as the adaptive schemes call it; "
                  "device_ms_per_batch: the module's kernels on a tensor on the card"})
    if not np.isfinite(e).all():
        raise RuntimeError("the LPIPS embedding is not finite")
    return counts


def _loader_costs(loop, card):
    """ms per batch (B=2, T=100, 128 px) of the native loader, the Python
    thread loader and the synchronous generator on the fixture; and the
    train step's host batch time (``next_step_inputs``) inside 3 steps of the
    CLI's loop with its prefetching native loader, against 3 back-to-back
    draws from the synchronous generator."""
    from lfvdm_tpu_torch.data import datasets as data

    kw = dict(batch_size=FLAGSHIP_B, T=CLI_VIDEO_T, seed=0)
    native = _timed_batches(data.load_data(CLI_DATASET, **kw), CLI_LOADER_BATCHES)
    os.environ["LFVDM_NATIVE_LOADER"] = "0"
    try:
        thread = _timed_batches(data.load_data(CLI_DATASET, **kw), CLI_LOADER_BATCHES)
    finally:
        del os.environ["LFVDM_NATIVE_LOADER"]
    dataset = data.load_data(CLI_DATASET, return_dataset=True, **kw)
    sync = _timed_batches(data.batch_generator(dataset, FLAGSHIP_B), CLI_LOADER_BATCHES)

    in_step = _host_batch_ms_in_steps(loop, 3)
    loop.data = data.batch_generator(dataset, FLAGSHIP_B)
    sync_step = _host_batch_ms_back_to_back(loop, 3)
    return {"phase": "cli_loaders", "card": card, "batch": [FLAGSHIP_B, CLI_VIDEO_T, 3, 128, 128],
            "native_ms_per_batch": native, "thread_ms_per_batch": thread,
            "sync_ms_per_batch": sync, "host_batch_ms_in_step_prefetch": in_step,
            "host_batch_ms_sync_back_to_back": sync_step}


@contextlib.contextmanager
def timed_draws(loop):
    """Inside, each ``loop.next_step_inputs()`` call (the host's batch
    drawing, masking and upload, synchronised) appends its seconds to the
    list this yields."""
    import torch

    inner, times = loop.next_step_inputs, []

    def timed():
        t0 = time.perf_counter()
        out = inner()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    loop.next_step_inputs = timed
    try:
        yield times
    finally:
        del loop.next_step_inputs


def _host_batch_ms_in_steps(loop, steps):
    """Mean ms of ``loop.next_step_inputs`` inside ``steps`` train steps."""
    with timed_draws(loop) as times:
        for _ in range(steps):
            loop.run_step()
            loop.step += 1
    return sum(times) / len(times) * 1e3


def _host_batch_ms_back_to_back(loop, n):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loop.next_step_inputs()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


# ---------------------------------------------------------------------------
# Phase 10: the evals — FVD with I3D, the CARLA coordinate regressor, the scripts
# ---------------------------------------------------------------------------

EVALS_VIDEOS, EVALS_T = 16, 16  # per sample-format set; frames per video
EVALS_SIZES = (128, 256)  # the flagship's pixels, and the latent path's decoded ones
EVALS_COORDS_BATCH = 64
EVALS_TRAIN = dict(n_train=3, n_test=1, T=8, size=128)  # 24 train frames: 6 steps of 4


def _rel_l2(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _write_sample_sets(samples_dir, size, seed):
    """Two sample-format sets of EVALS_VIDEOS uint8 (EVALS_T, 3, size, size)
    videos in one samples directory: set A as ``sample_XXXX-0.npy`` (uniform
    noise), set B as ``sample_XXXX-1.npy`` (the same noise, box-blurred over
    3x3 pixels: another distribution)."""
    import numpy as np

    os.makedirs(samples_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(EVALS_VIDEOS):
        a = rng.integers(0, 256, (EVALS_T, 3, size, size), dtype=np.uint8)
        pad = np.pad(a.astype(np.float32), ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge")
        b = sum(pad[..., dy:dy + size, dx:dx + size] for dy in range(3) for dx in range(3)) / 9
        np.save(os.path.join(samples_dir, f"sample_{i:04d}-0.npy"), a)
        np.save(os.path.join(samples_dir, f"sample_{i:04d}-1.npy"), b.astype(np.uint8))


def write_regressor_fixture(root, seed=50, n_train=3, n_test=1, T=8, size=128):
    """The CARLA layout carla_regressor_train reads: video_{train,test}.csv,
    uint8 (T, size, size, 3) ``.pt`` videos and (T, 3) ``coords_*.npy``
    world coordinates in the Town01 range, drawn from ``seed``."""
    import numpy as np
    import torch

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    splits = {"train": [], "test": []}
    for i in range(n_train + n_test):
        name = f"video_{i:05d}.pt"
        torch.save(torch.from_numpy(rng.integers(0, 256, (T, size, size, 3), dtype=np.uint8)),
                   os.path.join(root, name))
        np.save(os.path.join(root, f"coords_{i:05d}.npy"),
                rng.uniform(-10, 400, (T, 3)).astype(np.float32))
        splits["train" if i < n_train else "test"].append(name)
    for split, names in splits.items():
        with open(os.path.join(root, f"video_{split}.csv"), "w") as f:
            f.write("".join(f"videos/{n}\n" for n in names))
    return root


def phase_evals(ckpt_root, card):
    """Phase 10, at PyTorch's TF32 defaults (the evals' own scope turns TF32
    off): a. I3D on the card against the machine's CPU; b. video_fvd.main
    with --real_dir at 128 and 256 px (self ≈ 0, cross > 0); c.
    video_to_world_coords.main with a seeded full-width classifier and
    regressor; d. carla_regressor_train.main, one epoch of each mode, whose
    checkpoints the predictor loads. No port kernel launches on this path."""
    import numpy as np
    import torch

    from lfvdm_tpu_torch.evals import carla_regressor as cr
    from lfvdm_tpu_torch.evals.fvd import FVD, preprocess
    from lfvdm_tpu_torch.evals.i3d import I3DFeatureExtractor
    from lfvdm_tpu_torch.ops import attention as ops
    from lfvdm_tpu_torch.scripts import carla_regressor_train, video_fvd, video_to_world_coords

    tmp = tempfile.mkdtemp(prefix="chip_smoke_evals_", dir=ckpt_root)
    ops.reset_launch_counts()
    try:
        # a. I3D, card against CPU.
        clip = np.random.default_rng(40).uniform(-1, 1, (1, 16, 224, 224, 3)).astype(np.float32)
        t0 = time.perf_counter()
        want = I3DFeatureExtractor(device="cpu")(clip)
        cpu_s = time.perf_counter() - t0
        ext = I3DFeatureExtractor(device="cuda")
        got = ext(clip)
        x = torch.as_tensor(clip, device="cuda").permute(0, 4, 1, 2, 3)
        row = {"phase": "evals_i3d", "card": card, "clip": list(clip.shape),
               "rel_l2_vs_cpu": _rel_l2(got, want), "bound": 1e-3, "cpu_s": cpu_s,
               "device_ms_per_clip": cuda_ms(lambda: ext.features(x), 5, warmup=1),
               "tf32_after": [torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32]}
        emit(row)
        if not (np.isfinite(got).all() and row["rel_l2_vs_cpu"] <= 1e-3):
            raise RuntimeError(f"I3D on the card vs the CPU: {row['rel_l2_vs_cpu']}")
        del ext, x

        # b. video_fvd at 128 and 256 px.
        eval_dirs = []
        for size in EVALS_SIZES:
            eval_dir = os.path.join(tmp, f"eval_{size}")
            _write_sample_sets(os.path.join(eval_dir, "samples"), size, seed=41 + size)
            with open(os.path.join(eval_dir, "model_config.json"), "w") as f:
                json.dump({"dataset": "synthetic", "T": EVALS_T}, f)
            eval_dirs.append(eval_dir)
            videos = np.stack([np.load(os.path.join(eval_dir, "samples", f"sample_{i:04d}-0.npy"))
                               .transpose(0, 2, 3, 1) for i in range(EVALS_VIDEOS)])
            fvd = FVD(batch_size=EVALS_VIDEOS, device="cuda")
            fvd.extract_features(videos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = fvd.extract_features(videos)
            features_ms = (time.perf_counter() - t0) / EVALS_VIDEOS * 1e3
            on_card = torch.as_tensor(videos, device="cuda")
            resize_ms = cuda_ms(lambda: preprocess(on_card), 5, warmup=1) / EVALS_VIDEOS
            del fvd, on_card
            scores, wall = {}, {}
            for which, idx in (("self", 0), ("cross", 1)):
                argv = ["--eval_dir", eval_dir, "--num_videos", str(EVALS_VIDEOS),
                        "--sample_idx", str(idx), "--real_dir", os.path.join(eval_dir, "samples")]
                t0 = time.perf_counter()
                scores[which] = video_fvd.main(argv)
                wall[which] = time.perf_counter() - t0
            again = video_fvd.main(argv)
            row = {"phase": "evals_fvd", "card": card, "size": size,
                   "videos": [EVALS_VIDEOS, EVALS_T, size, size, 3],
                   "antialias": size > 224, "fvd_self": scores["self"],
                   "fvd_cross": scores["cross"], "features_ms_per_video": features_ms,
                   "resize_device_ms_per_video": resize_ms,
                   "s_per_fvd": wall, "features_finite": bool(np.isfinite(feats).all()),
                   "second_run_reads_file": again == scores["cross"],
                   "note": "s_per_fvd: video_fvd.main wall time, I3D set-up and file reads "
                           "included; features_ms_per_video: one 16-video chunk, uint8 "
                           "upload to features on the host; resize_device_ms_per_video: the "
                           "resize and scale alone (CUDA events)"}
            emit(row)
            if not (abs(scores["self"]) < 1 and math.isfinite(scores["cross"])
                    and scores["cross"] > 0 and row["features_finite"]
                    and again == scores["cross"]):
                raise RuntimeError(f"FVD at {size} px: {row}")

        # c. video_to_world_coords with a seeded classifier and regressor.
        paths = []
        for name, module in (("classifier", cr.ResNet152Classifier()),
                             ("regressor", cr.MultiHeadResNet152())):
            paths.append(os.path.join(tmp, f"{name}.pt"))
            torch.save(cr.seeded_init(module, seed=len(paths)).state_dict(), paths[-1])
        argv = ["--eval_dir", eval_dirs[0], "--classifier_path", paths[0],
                "--regressor_path", paths[1], "--batch_size", str(EVALS_COORDS_BATCH)]
        t0 = time.perf_counter()
        written = video_to_world_coords.main(argv)
        coords_s = time.perf_counter() - t0
        again = video_to_world_coords.main(argv)
        shapes = sorted({np.load(p).shape for p in written})
        finite = all(np.isfinite(np.load(p)).all() for p in written)
        pred = cr.load_classifier_regressor_like_paper(*paths, device="cuda")
        cpu = cr.load_classifier_regressor_like_paper(*paths, device="cpu")
        frames = np.load(os.path.join(eval_dirs[0], "samples", "sample_0000-0.npy"))
        four = frames[:4].astype(np.float32)
        rel = _rel_l2(pred.predict_coords(four), cpu.predict_coords(four))
        batch = np.concatenate([frames] * (EVALS_COORDS_BATCH // EVALS_T)).astype(np.float32)
        pred.predict_coords(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_coords(batch)
        ms_per_frame = (time.perf_counter() - t0) / len(batch) * 1e3
        n_frames = 2 * EVALS_VIDEOS * EVALS_T
        row = {"phase": "evals_coords", "card": card, "videos": len(written),
               "frames": n_frames, "size": EVALS_SIZES[0],
               "coords_shapes": [list(s) for s in shapes],
               "finite": finite, "second_run_written": len(again),
               "rel_l2_vs_cpu_4_frames": rel, "bound": 1e-3,
               "script_ms_per_frame": coords_s / n_frames * 1e3,
               "ms_per_frame_batch_64": ms_per_frame,
               "note": "script_ms_per_frame: video_to_world_coords.main wall time over its "
                       "16-frame videos (one batch each), checkpoint loading, model set-up "
                       "and file reads included; "
                       "ms_per_frame_batch_64: predict_coords on 64 frames, numpy in and out"}
        emit(row)
        if not (len(written) == 2 * EVALS_VIDEOS and shapes == [(EVALS_T, 2)] and finite
                and not again and rel <= 1e-3):
            raise RuntimeError(f"world coordinates: {row}")
        del pred, cpu

        # d. carla_regressor_train, one epoch of each mode.
        data_dir = write_regressor_fixture(os.path.join(tmp, "carla"), **EVALS_TRAIN)
        ckpts = []
        for is_classifier in (True, False):
            out_dir = os.path.join(tmp, f"regressor_{is_classifier}")
            t0 = time.perf_counter()
            run = carla_regressor_train.main(["--data_dir", data_dir, "--num_epochs", "1",
                                              "--is_classifier", str(is_classifier),
                                              "--out_dir", out_dir])
            wall_s = time.perf_counter() - t0
            losses = run["epochs"][0]
            emit({"phase": "evals_regressor_train", "card": card,
                  "is_classifier": is_classifier, "frames": EVALS_TRAIN, "losses": losses,
                  "saved": [os.path.basename(p) for p in run["saved"]], "wall_s": wall_s})
            if not (all(math.isfinite(v) for v in losses.values()) and len(run["saved"]) == 1):
                raise RuntimeError(f"regressor training: {run}")
            ckpts.append(run["saved"][0])
        trained = cr.load_classifier_regressor_like_paper(*ckpts, device="cuda")
        coords = trained.predict_coords(four)
        emit({"phase": "evals_trained_predictor", "card": card, "coords": coords.tolist()})
        if coords.shape != (4, 2) or not np.isfinite(coords).all():
            raise RuntimeError(f"the trained checkpoints gave {coords}")
        launches, _ = read_counts()
        if any(launches.values()):
            raise RuntimeError(f"the evals path launched port kernels: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


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
    reuse = phase_reuse(cfg, model, card)
    ckpt_root = os.path.join(here, "checkpoints")
    os.makedirs(ckpt_root, exist_ok=True)
    serve = phase_serve(cfg, model, card, ckpt_root)
    del model
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=ckpt_root)
    try:
        train_launches, train_routes = phase_train(ckpt_dir)
        phase_serve_params(ckpt_dir, card)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    phase_train_parity()
    parallel = phase_parallel(ckpt_root, card)
    latent = phase_latent(ckpt_root, card)
    cli = phase_cli(ckpt_root, card)
    with torch_tf32_defaults():
        phase_evals(ckpt_root, card)
    launches = {"train": train_launches, "sample_video": sample_launches}
    routes = {"train": train_routes, "sample_video": sample_routes}
    for path, (c, r) in {**reuse, **serve, **parallel, **latent, **cli}.items():
        launches[path], routes[path] = c, r
    emit(kernels_line(results, launches, routes))
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
