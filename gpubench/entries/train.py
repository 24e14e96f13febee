"""Entry ``train``: the port's ``TrainLoop.run_step`` on its captured step
(one CUDA graph of the whole optimizer step: forward with the three
kernels, backward, AdamW and the EMA in the fused update kernel), fed by
``data/datasets.py`` ``load_data`` as ``video_train`` calls it, through the
benchmark's wrapper of the batch iterator (which times the waits and keeps
the first steps' batches for the check).

The data is a CARLA dataset in its own layout, written by the benchmark in
set-up under ``$TMPDIR/gpubench_data`` (the port's ``DATA_ROOT``) and
removed after the check: ``video_train.csv`` naming ``videos`` clips and,
beside each name, its ``.npy`` of uint8 (T, H, W, C) frames drawn from the
seed, which the port's native loader streams, as it streams CARLA
converted to ``.npy``. A run that the native loader does not serve fails.

Traffic keys: ``dataset`` (the port's name of the layout), ``data_dir``
(its path under ``DATA_ROOT``), ``videos``, ``video_length`` (T, the clips'
frames and the loader's), ``image_size``, ``batch_size``, ``max_frames``
(K), ``lr``, ``ema_rate``, ``log_interval``, ``warmup_steps`` (the first
three are checked) and ``warmup_seconds`` (steps run before the window, at
least), ``trace_units``, ``settle_units``. The loop is seeded with the
run's seed: its host draws (frames, masks, timesteps), its device noise and
the loader's order.

The window runs ``run_step`` until ``--seconds`` have passed and ends at a
synchronise after the last step. The check, after the window: the loader's
rows against the clips, then the reference's three steps from the same
weights, batches and draws (plain f32 U-Net, its loss and autograd
gradients, AdamW and the EMA): each step's loss, the first gradient per
leaf as the optimizer holds it after one step (its first moment over
1 − β1), and each leaf's change after three steps.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from common import full_f32, sub_seed, sync, worst_leaf_gap
from program import build_diffusion, build_unet, unet_weights
from reference.diffusion import Diffusion
from reference.training import adamw_ema, carla_frames, sample_training_batch, uniform_timesteps
from reference.unet import UNet

W_WEIGHTS, W_DATA = 1, 200
CHECKED_STEPS = 3
B1 = 0.9


class TimedBatches:
    """The loader as ``TrainLoop`` sees it: each ``next`` timed (the span
    ``data_wait``), the first ``keep`` batches kept."""

    def __init__(self, source, run, keep):
        self.source, self.run, self.keep, self.kept = source, run, keep, []

    def __iter__(self):
        return self

    def __next__(self):
        with self.run.span("data_wait"):
            batch = next(self.source)
        if len(self.kept) < self.keep:
            self.kept.append(np.array(batch, copy=True))
        return batch


def data_root() -> Path:
    return Path(tempfile.gettempdir()) / "gpubench_data"


def clip(cfg, tr, seed, index) -> np.ndarray:
    """Clip ``index`` of the run's dataset: uint8 (T, H, W, C) drawn from
    the seed."""
    shape = (tr["video_length"], tr["image_size"], tr["image_size"], cfg["in_channels"])
    rng = np.random.default_rng(sub_seed(seed, W_DATA + index))
    return np.frombuffer(rng.bytes(int(np.prod(shape))), np.uint8).reshape(shape)


def write_dataset(cfg, tr, seed) -> Path:
    """The run's clips in the dataset's layout under ``data_root()``."""
    shutil.rmtree(data_root(), ignore_errors=True)
    where = data_root() / tr["data_dir"]
    where.mkdir(parents=True)
    names = [f"video_{i:04d}" for i in range(tr["videos"])]
    (where / "video_train.csv").write_text("".join(f"train/{n}.pt\n" for n in names))
    for i, name in enumerate(names):
        np.save(where / f"{name}.npy", clip(cfg, tr, seed, i))
    return data_root()


def run(run):
    from lfvdm_tpu_torch.data.datasets import load_data
    from lfvdm_tpu_torch.training.train_loop import TrainLoop

    cfg, tr, dev, seed = run.cell["config"], run.cell["traffic"], run.device, run.seed
    B, K = tr["batch_size"], tr["max_frames"]
    weights = unet_weights(cfg, sub_seed(seed, W_WEIGHTS), dev)
    model = build_unet(cfg, weights, dev)
    os.environ["DATA_ROOT"] = str(write_dataset(cfg, tr, seed))
    source = load_data(tr["dataset"], batch_size=B, T=tr["video_length"], seed=seed)
    data = TimedBatches(source, run, 2 * CHECKED_STEPS)
    loop = TrainLoop(model=model, diffusion=build_diffusion(cfg), data=data, batch_size=B,
                     max_frames=K, lr=tr["lr"], ema_rate=tr["ema_rate"],
                     log_interval=tr["log_interval"], seed=seed,
                     checkpoint_dir=os.path.join(tempfile.gettempdir(), "gpubench_train"))
    named = loop.state.named_params()
    losses, first_grad, after = [], None, None
    try:
        t_warm, step = time.perf_counter(), 0
        while step < tr["warmup_steps"] or time.perf_counter() - t_warm < tr["warmup_seconds"]:
            metrics = loop.run_step()
            if step < CHECKED_STEPS:
                losses.append(metrics["weighted_loss"].detach().clone())
            if step == 0:
                first_grad = {n: loop.state.optimizer.state[p]["exp_avg"].detach().clone()
                              for n, p in named}
            if step == CHECKED_STEPS - 1:
                after = {n: p.detach().clone() for n, p in named}
            step += 1
        sync(dev)
        if source.source != "native":
            raise RuntimeError(f"the {tr['dataset']} clips were read by the {source.source} "
                               "loader, not the native one")

        run.start_window()
        step_losses = []
        while run.remaining() > 0:
            metrics = loop.run_step()
            step_losses.append(metrics["weighted_loss"])
            run.finish_unit(B * K)
        run.close_window()
    finally:
        source.close()
    run.attempted = len(step_losses)
    run.failed = int(sum(not bool(torch.isfinite(v)) for v in step_losses))
    run.counts["update_elements"] = sum(p.numel() for _, p in named)
    run.counts["ema_rates"] = len(loop.state.ema)
    from work import unet_train_step

    step_work = unet_train_step(cfg, B, K)
    run.work["unit_flops"] = [step_work["flops"]] * len(step_losses)
    traced = min(tr["trace_units"], len(step_losses))
    run.work["kernel_least_s"] = sum(step_work["kernels"].values()) * traced
    run.work["traced_steps"] = traced
    return dict(weights=weights, batches=data.kept, losses=[float(v) for v in losses],
                first_grad=first_grad, after=after)


def reference_steps(cfg, tr, seed, weights, batches, dev, precision="float32", half=False,
                    frozen=False):
    """The reference's first steps from ``weights`` on the loader's
    ``batches`` (two per step) with the loop's draws re-made from the seed:
    returns (losses, first gradient by leaf, parameters after the steps).
    ``half``: the loss over the first half of each batch only, ``frozen``:
    no update (two faults)."""
    B, K = tr["batch_size"], tr["max_frames"]
    ref = UNet(cfg).to(dev).set_precision(precision)
    ref.load_state_dict(weights)
    params = dict(ref.named_parameters())
    names = list(params)
    m = [torch.zeros_like(params[n]) for n in names]
    v = [torch.zeros_like(params[n]) for n in names]
    ema = [params[n].detach().clone() for n in names]
    diff = Diffusion(cfg, "", device=dev)
    host = np.random.default_rng(seed)
    noise_gen = torch.Generator(device=dev).manual_seed(seed)
    losses, first = [], None
    for step in range(CHECKED_STEPS):
        b1, b2 = batches[2 * step], batches[2 * step + 1]
        x0, fi, obs, lat = sample_training_batch(host, b1, K, batch2=b2)
        t, w = uniform_timesteps(host, B, diff.n)
        x0 = torch.as_tensor(x0.astype(np.float32), device=dev)
        noise = torch.randn(x0.shape, generator=noise_gen, device=dev)
        window = dict(x0=x0, frame_indices=torch.as_tensor(fi, dtype=torch.int64, device=dev),
                      obs_mask=torch.as_tensor(obs, device=dev),
                      latent_mask=torch.as_tensor(lat, device=dev))
        t = torch.as_tensor(t, dtype=torch.int64, device=dev)
        w = torch.as_tensor(w, device=dev)
        rows = slice(0, B // 2) if half else slice(0, B)
        for p in params.values():
            p.grad = None
        _, loss = diff.loss(ref, x0[rows], t[rows], noise[rows], w[rows],
                            {k: a[rows] for k, a in window.items()})
        loss.backward()
        losses.append(float(loss.detach()))
        grads = [params[n].grad if params[n].grad is not None else torch.zeros_like(params[n])
                 for n in names]
        if step == 0:
            first = {n: float(g.double().norm()) for n, g in zip(names, grads)}
        if not frozen:
            adamw_ema([params[n].data for n in names], grads, m, v, ema, step + 1, tr["lr"],
                      rate=float(tr["ema_rate"]))
    return losses, first, {n: params[n].detach() for n in names}


def check(run, kept, control: bool = False):
    cfg, tr, dev, seed = run.cell["config"], run.cell["traffic"], run.device, run.seed
    limits = tr["limits"]
    clips = [clip(cfg, tr, seed, i) for i in range(tr["videos"])]
    shutil.rmtree(data_root(), ignore_errors=True)
    loader_mismatch = 0
    for batch in kept["batches"]:
        for row in batch:  # the clip whose first frame it has, then every frame
            same = [c for c in clips if np.array_equal(row[:1], carla_frames(c[:1]))]
            if not any(np.array_equal(row, carla_frames(c)) for c in same):
                loader_mismatch += 1
    run.checks["loader_mismatch"] = (loader_mismatch, limits["loader_mismatch"])

    weights = kept["weights"]
    with full_f32():
        losses, first, after = reference_steps(cfg, tr, seed, weights, kept["batches"], dev)
    numbers = _numbers(kept["losses"], losses, kept["first_grad"], first, kept["after"], after,
                       weights)
    for k, value in numbers.items():
        run.checks[k] = (value, limits[k])
    run.control = None
    if control:
        run.control = {}
        for name, kw in (("fp8", dict(precision="fp8")), ("half_batch", dict(half=True)),
                         ("unchanged_state", dict(frozen=True))):
            with full_f32():
                lo, fi, af = reference_steps(cfg, tr, seed, weights, kept["batches"], dev, **kw)
            run.control[name] = _numbers(lo, losses, fi, first, af, after, weights,
                                         moment=False)


def _numbers(got_losses, want_losses, got_first, want_first, got_after, want_after, start,
             moment=True):
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got_losses, want_losses))
    if moment:  # the program's first moment after one step is (1 − β1)·g
        got_first = {n: float(t.double().norm()) / (1 - B1) for n, t in got_first.items()}
    names = list(want_first)
    grad_gap = worst_leaf_gap(got_first, want_first, names)
    med = float(np.median([want_first[n] for n in names]))
    moved = [n for n in names if want_first[n] >= 1e-3 * med]
    got_delta = {n: float((got_after[n].double() - start[n].double()).norm()) for n in moved}
    want_delta = {n: float((want_after[n].double() - start[n].double()).norm()) for n in moved}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": worst_leaf_gap(got_delta, want_delta, moved)}
