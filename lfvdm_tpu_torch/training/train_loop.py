"""Training: the train step and the host loop (counterpart of
lfvdm_tpu/training/train_loop.py), on one card or one card per rank.

The step is the JAX package's, run eagerly: q_sample, the U-Net forward and
backward (its kernels launch in the forward, and again in the backward for
the blocks a ``use_checkpoint`` model rematerialises; each kernel
operator's backward is plain PyTorch), the weighted loss, AdamW with the
optional linear LR anneal, the multi-rate f32 EMA and the non-finite skip.
The JAX step selects the old state on device when the gradient norm is not
finite; here the norm is read on the host (one sync per step) and a skipped
step touches neither the parameters, the Adam moments, the schedule count
nor any EMA.

In a group of more than one process the loop wraps the model for data
parallelism (``parallel/sharding.py``: DDP, or FSDP2 with ``fsdp`` > 1).
The gradient norm is then the global one, so every rank takes the same
skip decision; each rank's EMA follows its own parameters (under FSDP its
shards); checkpoints and ``ema_params`` gather the full tensors. Not
ported: the JAX package's fused-optimizer and bf16-EMA diagnostics, which
measured TPU memory.

The host loop keeps the JAX package's cadence: mask sampling on a numpy
generator, timestep importance sampling with loss-aware updates, log, save
and sample intervals with quartile loss KVs, the ``DIFFUSION_TRAINING_TEST``
early exit, and a checkpoint at the next step boundary on SIGTERM/SIGINT.
Device noise comes from a ``torch.Generator`` on the model's device, and the
ResBlocks' dropout masks from a second one, both seeded from ``seed`` plus
the rank, as the host generator is (the JAX step derives its dropout key
from the run's key), so the ranks draw different rows.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion.gaussian import GaussianDiffusion
from ..diffusion.resample import LossAwareSampler, ScheduleSampler, UniformSampler
from ..models.unet import set_dropout_generator
from ..parallel import sharding
from ..parallel.mesh import best_mesh_shape, make_mesh
from ..utils.device import any_rank, process_index_and_count
from ..utils.logger import logger
from . import checkpoint as ckpt_lib
from .masks import sample_training_batch

METRIC_TERMS = ("mse", "vb", "eval-mse")


def _linear_anneal(count: int, steps: int) -> float:
    """optax.linear_schedule(1, 0, steps) at ``count``."""
    return 1.0 - min(count, steps) / steps


def make_optimizer(params, lr: float, weight_decay: float, lr_anneal_steps: int = 0):
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay, the update of
    ``optax.adamw``) and, with ``lr_anneal_steps``, a ``LambdaLR`` that decays
    the LR linearly to 0, read at the count of updates made so far as optax's
    schedule is. Returns (optimizer, scheduler or None)."""
    optimizer = torch.optim.AdamW([{"params": g} for g in _by_kind(params)], lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    scheduler = None
    if lr_anneal_steps:
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, functools.partial(_linear_anneal, steps=lr_anneal_steps))
    return optimizer, scheduler


@dataclasses.dataclass
class TrainState:
    """The model (as the step runs it: plain, DDP or FSDP2), its optimizer and
    schedule, one f32 EMA copy per rate ({param name: tensor}, laid out as
    the parameter) and the number of steps taken (skipped included)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    ema: Dict[str, Dict[str, torch.Tensor]]
    step: int = 0

    def named_params(self):
        """(name, parameter) pairs, named as in the unwrapped model."""
        return list(sharding.unwrap(self.model).named_parameters())

    def state_dict(self) -> dict:
        """A plain dict of full tensors keyed by parameter name (the
        checkpoint format, and what ``utils.convert.train_state_from_jax``
        builds). Under FSDP2 every rank must call it: it gathers."""
        full = sharding.full_tensor
        params, exp_avg, exp_avg_sq = {}, {}, {}
        count = 0
        for name, p in self.named_params():
            params[name] = full(p.detach())
            st = self.optimizer.state.get(p, {})
            exp_avg[name] = full(st.get("exp_avg", torch.zeros_like(p)).detach())
            exp_avg_sq[name] = full(st.get("exp_avg_sq", torch.zeros_like(p)).detach())
            if "step" in st:
                count = int(st["step"])
        schedule = self.scheduler.last_epoch if self.scheduler is not None else count
        ema = {rate: {n: full(t) for n, t in copy.items()} for rate, copy in self.ema.items()}
        return {"params": params, "ema": ema,
                "adam": {"count": count, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq},
                "schedule_count": int(schedule), "step": int(self.step)}

    def load_state_dict(self, state: dict):
        """Copy a ``state_dict()`` (full tensors on any device, the same on
        every rank) into this state, each tensor laid out as its parameter."""
        named = self.named_params()
        if set(state["ema"]) != set(self.ema):
            raise ValueError(f"EMA rates {sorted(state['ema'])} != {sorted(self.ema)}")
        adam = state["adam"]
        place = sharding.place_like
        with torch.no_grad():
            for name, p in named:
                p.copy_(place(state["params"][name], p))
                for rate in self.ema:
                    self.ema[rate][name].copy_(place(state["ema"][rate][name],
                                                     self.ema[rate][name]))
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(adam["count"]), dtype=torch.float32),
                    "exp_avg": place(adam["exp_avg"][name], p).clone(),
                    "exp_avg_sq": place(adam["exp_avg_sq"][name], p).clone(),
                }
        if self.scheduler is not None:
            count = int(state["schedule_count"])
            self.scheduler.last_epoch = count
            for group, base, fn in zip(self.optimizer.param_groups, self.scheduler.base_lrs,
                                       self.scheduler.lr_lambdas):
                group["lr"] = base * fn(count)
        self.step = int(state["step"])


def init_train_state(model: nn.Module, optimizer, scheduler, ema_rates) -> TrainState:
    """Fresh state: one f32 EMA copy of the parameters per rate, step 0."""
    named = list(sharding.unwrap(model).named_parameters())
    ema = {str(float(r)): {n: p.detach().float().clone() for n, p in named} for r in ema_rates}
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler, ema=ema)


def micro_loss(model, diffusion: GaussianDiffusion, batch: Dict[str, torch.Tensor], t, weights,
               *, noise=None, generator=None, pad_with_random_frames: bool = True,
               impl: str = "auto"):
    """Weighted mean loss over one (micro)batch, and the per-element terms.

    With ``pad_with_random_frames`` the loss also covers the padding frames:
    loss mask = 1 - obs_mask (the reference's semantics)."""
    x0 = batch["x0"]
    model_kwargs = dict(x0=x0, frame_indices=batch["frame_indices"],
                        obs_mask=batch["obs_mask"], latent_mask=batch["latent_mask"])
    loss_mask = (1.0 - batch["obs_mask"]) if pad_with_random_frames else batch["latent_mask"]

    def model_fn(x, ts, **kw):
        out, _ = model(x, ts, impl=impl, **kw)
        return out

    terms = diffusion.training_losses(model_fn, x0, t, model_kwargs=model_kwargs, noise=noise,
                                      generator=generator, latent_mask=loss_mask,
                                      eval_mask=batch["latent_mask"])
    return (terms["loss"] * weights).mean(), terms


def _by_kind(items, tensor_of=lambda x: x) -> List[list]:
    """``items`` grouped by the kind of their tensor, in order. Under FSDP2 the
    sharded parameters are DTensors and the replicated ones plain tensors,
    which one foreach kernel (the optimizer's default on the card, the EMA's
    everywhere) cannot take together."""
    kinds: Dict[type, list] = {}
    for x in items:
        kinds.setdefault(type(tensor_of(x).detach()), []).append(x)
    return list(kinds.values())


def _ema_update(ema: Dict[str, Dict[str, torch.Tensor]], named):
    for group in _by_kind([(n, p.detach()) for n, p in named], tensor_of=lambda x: x[1]):
        for rate, copy in ema.items():
            r = float(rate)
            e = [copy[n] for n, _ in group]
            torch._foreach_mul_(e, r)                    # e·r + p·(1 − r), in f32
            torch._foreach_add_(e, [p for _, p in group], alpha=1.0 - r)


def backward_microbatches(model, diffusion: GaussianDiffusion, batch: Dict[str, torch.Tensor],
                          t: torch.Tensor, weights: torch.Tensor, *, noise=None, generator=None,
                          n_microbatches: int = 1, pad_with_random_frames: bool = True,
                          impl: str = "auto"):
    """Accumulate the step's gradient into the parameters' ``.grad``.

    The batch splits into ``n_microbatches`` equal chunks and each chunk's
    gradient of its own weighted mean loss is SUMMED (the reference's
    accumulation); a wrapped model reduces gradients across ranks in the
    last chunk's backward only. ``noise`` (x0's shape) is injected, else
    each chunk draws its own from ``generator``. Returns (the summed loss,
    the per-element terms of the whole batch), detached."""
    B = batch["x0"].shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not split into {n_microbatches} microbatches")
    mb = B // n_microbatches
    loss = torch.zeros((), device=batch["x0"].device)
    chunk_terms: List[Dict[str, torch.Tensor]] = []
    for i in range(n_microbatches):
        part = slice(i * mb, (i + 1) * mb)
        with sharding.grad_sync(model, i == n_microbatches - 1):
            loss_i, terms_i = micro_loss(
                model, diffusion, {k: v[part] for k, v in batch.items()}, t[part],
                weights[part], noise=None if noise is None else noise[part],
                generator=generator, pad_with_random_frames=pad_with_random_frames, impl=impl)
            loss_i.backward()
        loss = loss + loss_i.detach()
        chunk_terms.append({k: v.detach() for k, v in terms_i.items()})
    return loss, {k: torch.cat([c[k] for c in chunk_terms]) for k in chunk_terms[0]}


def apply_gradients(state: TrainState):
    """The update from the accumulated ``.grad``: AdamW, the LR schedule and
    every EMA when the global gradient norm is finite, nothing otherwise.
    Clears the gradients and advances ``state.step`` either way. Returns
    (the gradient norm over every rank, whether the update was made)."""
    named = state.named_params()
    for _, p in named:
        if p.grad is None:  # an unused parameter: a zero gradient, as in JAX
            p.grad = torch.zeros_like(p)
    sharding.sync_replicated_grads(state.model)
    grad_norm = sharding.global_grad_norm([p.grad for _, p in named])
    finite = bool(torch.isfinite(grad_norm))  # the step's one host sync
    if finite:
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        _ema_update(state.ema, named)
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return grad_norm.detach(), finite


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], t: torch.Tensor,
               weights: torch.Tensor, *, diffusion: GaussianDiffusion, noise=None,
               generator=None, n_microbatches: int = 1,
               pad_with_random_frames: bool = True) -> Dict[str, torch.Tensor]:
    """One optimizer step in place on ``state`` (``backward_microbatches``,
    then ``apply_gradients``); returns the step's metrics."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, terms = backward_microbatches(
        state.model, diffusion, batch, t, weights, noise=noise, generator=generator,
        n_microbatches=n_microbatches, pad_with_random_frames=pad_with_random_frames)
    grad_norm, finite = apply_gradients(state)
    metrics = {"loss": terms["loss"], "grad_norm": grad_norm,
               "skipped_nonfinite": torch.tensor(float(not finite)), "weighted_loss": loss}
    metrics.update({k: terms[k] for k in METRIC_TERMS if k in terms})
    return metrics


def log_loss_dict(diffusion, ts, losses: Dict[str, np.ndarray], weights: np.ndarray):
    """Mean and per-quartile KV logging."""
    for key, values in losses.items():
        values = np.asarray(values) * weights if np.asarray(values).ndim else values
        logger.logkv_mean(key, float(np.mean(values)))
        for sub_t, sub_loss in zip(np.asarray(ts), np.asarray(values).reshape(-1)):
            quartile = int(4 * sub_t / diffusion.num_timesteps)
            logger.logkv_mean(f"{key}_q{quartile}", float(sub_loss))


def _numpy(v) -> np.ndarray:
    return v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class TrainLoop:
    """Host driver: data -> masks -> train step; logging, checkpoint and
    sampling cadence. The model's device is the training device.

    ``mesh``, ``fsdp``, ``fsdp_min_size``: data parallelism, as the JAX
    loop takes them. In a group of more than one process (or with a
    ``mesh`` given) the model is wrapped by ``sharding.wrap_for_training``:
    DDP with ``fsdp == 1``, FSDP2 over the (dp, fsdp) mesh with ``fsdp`` > 1,
    parameters under ``fsdp_min_size`` elements replicated. A model that
    arrives wrapped (``sharding.shard_model``) is trained as it is. Each
    rank loads its own ``batch_size`` rows.

    ``init_params``: a ``state_dict`` to start from (a fine-tune; its names
    and shapes must match the model's). ``codec`` (``diffusion/codecs.py``)
    maps each prepared batch into diffusion space: ``VAECodec`` encodes the
    chosen frames on the training device (the mean of each frame's latent
    distribution, as the JAX loop does with no key); the pre-encoded codec's
    encode is the identity. ``profile_dir``: a ``torch.profiler``
    trace of steps [profile_start_step, + profile_num_steps) is written there.
    """

    def __init__(
        self,
        *,
        model: nn.Module,
        diffusion: GaussianDiffusion,
        data,
        batch_size: int,
        max_frames: int,
        lr: float,
        ema_rate="0.9999",
        log_interval: int = 10,
        save_interval: int = 50_000,
        sample_interval: Optional[int] = None,
        lr_anneal_steps: int = 0,
        weight_decay: float = 0.0,
        microbatch: int = -1,
        pad_with_random_frames: bool = True,
        schedule_sampler: Optional[ScheduleSampler] = None,
        checkpoint_dir: str = "checkpoints/run",
        resume: bool = False,
        init_params=None,
        config: Optional[Dict] = None,
        mesh=None,
        fsdp: int = 1,
        fsdp_min_size: int = 2**16,
        seed: int = 0,
        sample_fn: Optional[Callable] = None,
        profile_dir: Optional[str] = None,
        profile_start_step: int = 10,
        profile_num_steps: int = 5,
        codec=None,
    ):
        self.device = next(model.parameters()).device
        self.rank, self.world = process_index_and_count()
        self.diffusion = diffusion
        self.data = data
        self.batch_size = batch_size
        self.max_frames = max_frames
        # Gradient accumulation (reference `microbatch`): <= 0 disables.
        if 0 < microbatch < batch_size:
            if batch_size % microbatch:
                raise ValueError(f"batch_size={batch_size} not divisible by "
                                 f"microbatch={microbatch}")
            self.n_microbatches = batch_size // microbatch
        else:
            self.n_microbatches = 1
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.sample_interval = sample_interval
        self.lr_anneal_steps = lr_anneal_steps
        self.pad_with_random_frames = pad_with_random_frames
        self.codec = codec
        self.schedule_sampler = schedule_sampler or UniformSampler(diffusion)
        self.checkpoint_dir = checkpoint_dir
        self.config = config or {}
        self.sample_fn = sample_fn
        self.profile_dir = profile_dir
        self.profile_start_step = profile_start_step
        self.profile_num_steps = profile_num_steps
        self._profiler = None
        self.ema_rates = ([ema_rate] if isinstance(ema_rate, float)
                          else [float(x) for x in str(ema_rate).split(",")])
        best_mesh_shape(self.world, fsdp)  # refuses an fsdp size the group does not split into
        if mesh is None and self.world > 1:
            mesh = make_mesh(fsdp=fsdp, device_type=self.device.type)
        # Each microbatch chunk must still cover the mesh's data shards: the
        # global rows of a chunk are the local chunk's times the processes.
        if mesh is not None and self.n_microbatches > 1:
            global_chunk = (batch_size // self.n_microbatches) * self.world
            if global_chunk % mesh.size():
                raise ValueError(f"microbatch={microbatch} leaves {global_chunk} global rows per "
                                 f"chunk, not divisible by the mesh's {mesh.size()} data "
                                 "shards — raise microbatch or shrink the mesh")
        self.mesh = mesh
        seed += self.rank
        self.host_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # A stream of its own for the dropout masks, derived from the seed.
        dropout_seed = int(np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0])
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(dropout_seed)

        self.model = model
        if init_params is not None:
            self._warm_start(init_params)
        # The layout of a plain replica, for sampling in one process
        # (``sampling_model``); none for a model that arrives sharded.
        plain = sharding.unwrap(model)
        self._skeleton = None if sharding.is_sharded(plain) else copy.deepcopy(plain).to("meta")
        set_dropout_generator(model, self.dropout_generator)
        self.model = sharding.wrap_for_training(model, mesh, fsdp, fsdp_min_size)
        optimizer, scheduler = make_optimizer(self.model.parameters(), lr, weight_decay,
                                              lr_anneal_steps)
        self.state = init_train_state(self.model, optimizer, scheduler, self.ema_rates)

        self.step = 0
        self._pending = []
        self._interrupted = False
        self._window_start = time.time()
        if resume:
            latest = ckpt_lib.find_latest_step(checkpoint_dir)
            if latest is not None:
                saved, self.step, _ = ckpt_lib.load_checkpoint(checkpoint_dir, latest)
                self.state.load_state_dict(saved)
                print(f"resumed from step {self.step}")
        logger.logkv("num_parameters", sum(p.numel() for p in self.model.parameters()))

    def _warm_start(self, init_params):
        own = self.model.state_dict()
        given = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                 for k, v in init_params.items()}
        if set(given) != set(own):
            missing = sorted(set(own) - set(given))[:5]
            extra = sorted(set(given) - set(own))[:5]
            raise ValueError(f"init_params names differ (missing={missing}, extra={extra}) "
                             "— wrong architecture config for this checkpoint?")
        for name, ref in own.items():
            if tuple(given[name].shape) != tuple(ref.shape):
                raise ValueError(f"init_params shape mismatch at {name}: "
                                 f"{tuple(given[name].shape)} vs model {tuple(ref.shape)}")
        self.model.load_state_dict({k: v.to(torch.float32) for k, v in given.items()})

    # ---- host-side plumbing ----

    def _next_batch(self) -> np.ndarray:
        return np.asarray(next(self.data))

    def _prepare(self, batch1, batch2) -> Dict:
        """Frames and masks of one step (numpy); with a codec, x0 is encoded
        after the frames are chosen and stays a tensor on the device."""
        x0, fi, obs, lat = sample_training_batch(
            self.host_rng, batch1, self.max_frames,
            batch2=batch2 if self.pad_with_random_frames else None,
            pad_with_random_frames=self.pad_with_random_frames)
        x0 = x0.astype(np.float32)
        if self.codec is not None:
            x0 = self.codec.encode(torch.as_tensor(x0, device=self.device))
        return {"x0": x0, "frame_indices": fi, "obs_mask": obs, "latent_mask": lat}

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A prepared batch as tensors on the training device."""
        dev = self.device
        return {"x0": torch.as_tensor(batch["x0"], dtype=torch.float32, device=dev),
                "frame_indices": torch.as_tensor(batch["frame_indices"], dtype=torch.int64,
                                                 device=dev),
                "obs_mask": torch.as_tensor(batch["obs_mask"], dtype=torch.float32, device=dev),
                "latent_mask": torch.as_tensor(batch["latent_mask"], dtype=torch.float32,
                                               device=dev)}

    def next_step_inputs(self):
        """Draw the next batch, its masks and its timesteps on the host.
        Returns (device batch, t, weights, t as numpy, weights as numpy)."""
        batch1 = self._next_batch()
        batch2 = self._next_batch() if self.pad_with_random_frames else batch1
        batch = self.to_device(self._prepare(batch1, batch2))
        t_np, w_np = self.schedule_sampler.sample(batch["x0"].shape[0], self.host_rng)
        t = torch.as_tensor(t_np, dtype=torch.int64, device=self.device)
        w = torch.as_tensor(w_np, dtype=torch.float32, device=self.device)
        return batch, t, w, t_np, w_np

    # ---- main loop ----

    def run_step(self):
        t0 = time.time()
        batch, t, w, t_np, w_np = self.next_step_inputs()
        metrics = train_step(self.state, batch, t, w, diffusion=self.diffusion,
                             generator=self.generator, n_microbatches=self.n_microbatches,
                             pad_with_random_frames=self.pad_with_random_frames)
        if isinstance(self.schedule_sampler, LossAwareSampler):
            self.schedule_sampler.update_with_local_losses(t_np, _numpy(metrics["loss"]))
        self._pending.append((self.step, t_np, w_np, metrics, time.time() - t0))
        if len(self._pending) >= self.log_interval:
            self._flush_metrics()
        return metrics

    def _flush_metrics(self):
        if not self._pending:
            return
        window = time.time() - self._window_start
        logger.logkv_mean("timing/step_time", window / len(self._pending))
        for step, t_np, w_np, metrics, host_time in self._pending:
            losses = {k: _numpy(v) for k, v in metrics.items() if k in ("loss",) + METRIC_TERMS}
            log_loss_dict(self.diffusion, t_np, losses, w_np)
            logger.logkv_mean("grad_norm", float(_numpy(metrics["grad_norm"])))
            if float(_numpy(metrics["skipped_nonfinite"])):
                logger.logkv("skipped_nonfinite_step", step)
                print(f"non-finite gradients at step {step}; step skipped")
            logger.logkv("step", step)
            logger.logkv("samples", (step + 1) * self.batch_size * self.world)
            logger.logkv_mean("timing/host_time", host_time)
        self._pending = []
        self._window_start = time.time()

    def run_loop(self, max_steps: Optional[int] = None):
        """Train until ``lr_anneal_steps`` or ``max_steps``. SIGTERM and
        SIGINT request a checkpoint and a clean exit at the next step
        boundary (handlers are installed from the main thread only)."""
        import signal
        import threading

        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            def _request_stop(signum, frame):
                print(f"signal {signum}: checkpointing at next step boundary")
                self._interrupted = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _request_stop)
        try:
            self._run_loop(max_steps)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            if self._profiler is not None:
                self._stop_profile()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(self.profile_dir, "train_trace.json"))
        self._profiler = None

    def _run_loop(self, max_steps: Optional[int] = None):
        last_sample_time = None
        while (not self.lr_anneal_steps or self.step < self.lr_anneal_steps) and (
                max_steps is None or self.step < max_steps):
            if (self.profile_dir is not None and self._profiler is None
                    and self.step == self.profile_start_step):
                self._start_profile()
            self.run_step()
            if self._profiler is not None and self.step >= (
                    self.profile_start_step + self.profile_num_steps - 1):
                self._stop_profile()
            # interval 0/None = disabled
            if self.log_interval and self.step % self.log_interval == 0:
                self._flush_metrics()
                logger.dumpkvs()
            if self.save_interval and self.step % self.save_interval == 0:
                self.save()
            if os.environ.get("DIFFUSION_TRAINING_TEST", "") and self.step > 0:
                return
            interrupted = self._interrupted
            if self.world > 1:
                # Signals reach the ranks at different steps; the ranks agree
                # at the log boundary, so every one enters the save at the
                # same step.
                interrupted = (bool(self.log_interval) and self.step % self.log_interval == 0
                               and any_rank(self._interrupted))
            if interrupted:
                self._flush_metrics()
                self.save()
                print(f"checkpointed at step {self.step} after interrupt; exiting")
                return
            if (self.sample_fn is not None and self.sample_interval is not None
                    and self.step != 0
                    and (self.step % self.sample_interval == 0 or self.step == 5)):
                if last_sample_time is not None:
                    logger.logkv("timing/time_between_samples", time.time() - last_sample_time)
                t0 = time.time()
                self.sample_fn(self)
                logger.logkv("timing/sampling_time", time.time() - t0)
                last_sample_time = time.time()
                self._window_start = time.time()  # keep step_time unpolluted
            self.step += 1
        if self.save_interval and (self.step - 1) % self.save_interval != 0:
            self.save()

    def save(self):
        """Every rank gathers the state; rank 0 writes it."""
        ckpt_lib.save_checkpoint(self.checkpoint_dir, self.step, self.state.state_dict(),
                                 config=self.config)

    @property
    def ema_params(self):
        """{rate: {name: full tensor}}; under FSDP2 every rank must read it
        (it gathers)."""
        return {rate: {n: sharding.full_tensor(t) for n, t in c.items()}
                for rate, c in self.state.ema.items()}

    def sampling_model(self, params: Dict[str, torch.Tensor]) -> nn.Module:
        """A plain replica of the model on the training device holding
        ``params`` (full tensors), for sampling in this process alone."""
        if self._skeleton is None:
            raise ValueError("the model arrived sharded: no plain replica to sample with")
        model = copy.deepcopy(self._skeleton).to_empty(device=self.device)
        model.load_state_dict(params)
        return model

