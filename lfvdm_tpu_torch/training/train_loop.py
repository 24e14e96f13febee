"""Training: the train step and the host loop (counterpart of
lfvdm_tpu/training/train_loop.py), on one card or one card per rank.

The step is the JAX package's: q_sample, the U-Net forward and backward (its
kernels launch in the forward, and again in the backward for the blocks a
``use_checkpoint`` model rematerialises; each kernel operator's backward is
plain PyTorch), the weighted loss, the global gradient norm, AdamW (optax's
update) with the optional linear LR anneal, and the multi-rate f32 EMA. As
in the JAX step, the non-finite skip is decided on the device: the new
parameters, Adam moments and EMA copies are selected against the old ones
with ``torch.where`` on the norm's finite flag (JAX's ``select``) and the
counts advance by that flag, so a skipped step leaves the state bitwise as
it was, and the step reads nothing back to the host. The Adam count and the
schedule's count are 0-d int64 tensors on the device, and the LR is
computed from the latter there.

On a card ``TrainLoop`` runs each step as one CUDA graph per step shape
(``training/graphs.py`` ``TrainProgram``, the counterpart of the JAX loop's
``jax.jit(train_step, donate_argnums=(0,))``), on one card and on every
rank of a group, with DDP's or FSDP2's collectives inside the graph; the
graph and the eager ``train_step`` run the same ``step_body``, so a
captured step is the eager one bit for bit. On the CPU the loop runs
``train_step`` eagerly.

In a group of more than one process the loop wraps the model for data
parallelism (``parallel/sharding.py``: DDP, or FSDP2 with ``fsdp`` > 1).
The gradient norm is then the global one, so every rank takes the same
skip decision; the update runs on each rank's local tensors (FSDP2's
shards); each rank's EMA follows its own parameters (under FSDP its
shards); checkpoints and ``ema_params`` gather the full tensors.

The update is one pass over every local tensor
(``ops.adamw.fused_adamw_ema``: AdamW, every EMA copy and the skip in one
CUDA kernel on the card), the counterpart of the JAX package's
``LFVDM_FUSED_OPT=1`` arm, which computes what its default optax chain
does; the port has no other update, so it does not read that switch.
``LFVDM_BF16_EMA=1``, read when the state is built (``init_train_state``),
stores the EMA copies in bfloat16 (f32 arithmetic, rounded to the copy);
off by default, as in JAX.

The host loop keeps the JAX package's cadence: mask sampling on a numpy
generator, timestep importance sampling with loss-aware updates, log, save
and sample intervals with quartile loss KVs, the ``DIFFUSION_TRAINING_TEST``
early exit, and a checkpoint at the next step boundary on SIGTERM/SIGINT.
Device noise comes from a ``torch.Generator`` on the model's device, drawn
before each step in the order the step takes it, and the ResBlocks' dropout
masks from a second one, both seeded from ``seed`` plus the rank, as the
host generator is (the JAX step derives its dropout key from the run's
key), so the ranks draw different rows.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion.gaussian import GaussianDiffusion, _randn
from ..diffusion.resample import LossAwareSampler, ScheduleSampler, UniformSampler
from ..models.unet import set_dropout_generator
from ..ops.adamw import fused_adamw_ema
from ..parallel import sharding
from ..parallel.mesh import best_mesh_shape, make_mesh
from ..utils.device import any_rank, process_index_and_count
from ..utils.logger import logger
from . import checkpoint as ckpt_lib
from .masks import sample_training_batch

METRIC_TERMS = ("mse", "vb", "eval-mse")


class AdamW:
    """``optax.adamw``'s hyperparameters (b1 0.9, b2 0.999, eps 1e-8, weight
    decay added to the normalised update) and state, which ``update_state``
    advances (``ops.adamw.fused_adamw_ema``). Its moments (``state[p]``:
    ``exp_avg``, ``exp_avg_sq``) are made zero at construction, laid out as
    the parameters; ``count``, the updates made, is a 0-d int64 tensor on
    the parameters' device."""

    def __init__(self, params, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.weight_decay, self.betas, self.eps = lr, weight_decay, betas, eps
        with torch.no_grad():
            self.state = {p: {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
                          for p in self.params}
        device = sharding.local(self.params[0]).device
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    def zero_grad(self):
        for p in self.params:
            p.grad = None


class LinearAnneal:
    """``optax.linear_schedule(1, 0, steps)`` read at ``count``, the updates
    made so far: a 0-d int64 tensor on ``device``."""

    def __init__(self, steps: int, device):
        self.steps = steps
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    def factor(self) -> torch.Tensor:
        return 1.0 - self.count.clamp(max=self.steps).to(torch.float32) / self.steps


def make_optimizer(params, lr: float, weight_decay: float, lr_anneal_steps: int = 0):
    """``AdamW`` and, with ``lr_anneal_steps``, a ``LinearAnneal`` that decays
    the LR linearly to 0, read at the count of updates made so far as
    optax's schedule is. Returns (optimizer, schedule or None)."""
    optimizer = AdamW(params, lr, weight_decay)
    schedule = LinearAnneal(lr_anneal_steps, optimizer.count.device) if lr_anneal_steps else None
    return optimizer, schedule


@dataclasses.dataclass
class TrainState:
    """The model (as the step runs it: plain, DDP or FSDP2), its optimizer and
    LR schedule, one EMA copy per rate ({param name: tensor}, laid out as
    the parameter, f32 or bf16) and the number of steps taken (skipped
    included)."""

    model: nn.Module
    optimizer: AdamW
    scheduler: Optional[LinearAnneal]
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
        for name, p in self.named_params():
            params[name] = full(p.detach())
            st = self.optimizer.state[p]
            exp_avg[name] = full(st["exp_avg"])
            exp_avg_sq[name] = full(st["exp_avg_sq"])
        count = int(self.optimizer.count)
        schedule = int(self.scheduler.count) if self.scheduler is not None else count
        ema = {rate: {n: full(t) for n, t in copy.items()} for rate, copy in self.ema.items()}
        return {"params": params, "ema": ema,
                "adam": {"count": count, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq},
                "schedule_count": schedule, "step": int(self.step)}

    def load_state_dict(self, state: dict):
        """Copy a ``state_dict()`` (full tensors on any device, the same on
        every rank) into this state's own tensors, in place, each laid out
        as its parameter: a captured step goes on reading them."""
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
                st = self.optimizer.state[p]
                st["exp_avg"].copy_(place(adam["exp_avg"][name], p))
                st["exp_avg_sq"].copy_(place(adam["exp_avg_sq"][name], p))
            self.optimizer.count.fill_(int(adam["count"]))
            if self.scheduler is not None:
                self.scheduler.count.fill_(int(state["schedule_count"]))
        self.step = int(state["step"])


def init_train_state(model: nn.Module, optimizer, scheduler, ema_rates) -> TrainState:
    """Fresh state: one EMA copy of the parameters per rate, step 0.

    The copies are f32, or bfloat16 when ``LFVDM_BF16_EMA`` is "1" (the JAX
    package's diagnostic, which halves the EMA's bytes in the update; NOT
    for production: checkpoints then carry bf16 EMAs, about 3 decimal
    digits, and the reference's eval protocol scores EMA weights). Read
    here, once."""
    named = list(sharding.unwrap(model).named_parameters())
    ema_dtype = torch.bfloat16 if os.environ.get("LFVDM_BF16_EMA", "0") == "1" else torch.float32
    ema = {str(float(r)): {n: p.detach().to(ema_dtype).clone() for n, p in named}
           for r in ema_rates}
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


def draw_noise(generator: torch.Generator, x0: torch.Tensor, n_microbatches: int = 1):
    """A step's noise (x0's shape) as the step would draw it from
    ``generator``: one block per microbatch, in order."""
    B = x0.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not split into {n_microbatches} microbatches")
    shape = (B // n_microbatches,) + tuple(x0.shape[1:])
    return torch.cat([_randn(shape, x0, generator) for _ in range(n_microbatches)])


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


@torch.no_grad()
def update_state(state: TrainState):
    """The update from the accumulated ``.grad``, decided on the device:
    AdamW, the schedule's count and every EMA take their new values where
    the global gradient norm is finite, and keep their old ones, bitwise,
    where it is not. One pass over each rank's local tensors
    (``fused_adamw_ema``); each EMA copy is e·r + p·(1 − r) in f32, stored
    at the copy's dtype. Reads nothing back to the host, and leaves the
    gradients and ``state.step`` alone. Returns (the gradient norm over
    every rank, whether it is finite), 0-d tensors on the device."""
    named = state.named_params()
    for _, p in named:
        if p.grad is None:  # an unused parameter: a zero gradient, as in JAX
            p.grad = torch.zeros_like(p)
    sharding.sync_replicated_grads(state.model)
    grad_norm = sharding.global_grad_norm([p.grad for _, p in named])
    finite = torch.isfinite(grad_norm)
    opt, schedule = state.optimizer, state.scheduler
    local = sharding.local
    moments = [opt.state[p] for _, p in named]
    fused_adamw_ema(
        [local(p) for _, p in named], [local(p.grad) for _, p in named],
        [local(m["exp_avg"]) for m in moments], [local(m["exp_avg_sq"]) for m in moments],
        [[local(ema[n]) for n, _ in named] for ema in state.ema.values()], finite,
        opt.count, lr=opt.lr, weight_decay=opt.weight_decay,
        rates=[float(r) for r in state.ema], betas=opt.betas, eps=opt.eps,
        lr_factor=None if schedule is None else schedule.factor())
    opt.count.add_(finite)
    if schedule is not None:
        schedule.count.add_(finite)
    return grad_norm.detach(), finite


def apply_gradients(state: TrainState):
    """``update_state``, then one more step taken. Returns (the gradient
    norm over every rank, whether it is finite), 0-d tensors on the
    device."""
    out = update_state(state)
    state.step += 1
    return out


def step_body(state: TrainState, batch: Dict[str, torch.Tensor], t: torch.Tensor,
              weights: torch.Tensor, *, diffusion: GaussianDiffusion, noise=None,
              generator=None, n_microbatches: int = 1,
              pad_with_random_frames: bool = True) -> Dict[str, torch.Tensor]:
    """The device work of one optimizer step (``backward_microbatches``,
    then ``update_state``) with no host read; returns the step's metrics,
    tensors on the device. What ``train_step`` runs, and what a
    ``TrainProgram`` captures: the gradients it leaves stay allocated."""
    state.model.train()
    state.optimizer.zero_grad()
    loss, terms = backward_microbatches(
        state.model, diffusion, batch, t, weights, noise=noise, generator=generator,
        n_microbatches=n_microbatches, pad_with_random_frames=pad_with_random_frames)
    grad_norm, finite = update_state(state)
    metrics = {"loss": terms["loss"], "grad_norm": grad_norm,
               "skipped_nonfinite": (~finite).to(torch.float32), "weighted_loss": loss}
    metrics.update({k: terms[k] for k in METRIC_TERMS if k in terms})
    return metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], t: torch.Tensor,
               weights: torch.Tensor, *, diffusion: GaussianDiffusion, noise=None,
               generator=None, n_microbatches: int = 1,
               pad_with_random_frames: bool = True) -> Dict[str, torch.Tensor]:
    """One optimizer step in place on ``state``, eagerly (``step_body``; the
    gradients are freed after it); returns the step's metrics."""
    metrics = step_body(state, batch, t, weights, diffusion=diffusion, noise=noise,
                        generator=generator, n_microbatches=n_microbatches,
                        pad_with_random_frames=pad_with_random_frames)
    state.optimizer.zero_grad()
    state.step += 1
    return metrics


def log_loss_dict(diffusion, ts, losses: Dict[str, np.ndarray], weights: np.ndarray):
    """Mean and per-quartile KV logging."""
    for key, values in losses.items():
        values = np.asarray(values) * weights if np.asarray(values).ndim else values
        logger.logkv_mean(key, float(np.mean(values)))
        for sub_t, sub_loss in zip(np.asarray(ts), np.asarray(values).reshape(-1)):
            quartile = int(4 * sub_t / diffusion.num_timesteps)
            logger.logkv_mean(f"{key}_q{quartile}", float(sub_loss))


BATCH_DTYPES = {"x0": torch.float32, "frame_indices": torch.int64,
                "obs_mask": torch.float32, "latent_mask": torch.float32}


def place(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` (a numpy array, or a tensor) as a ``dtype`` tensor on ``device``,
    placed as the JAX loop's ``device_put`` places it: on a CUDA device the
    host never waits for the card. The values are copied into a new
    page-locked block of PyTorch's caching host allocator (a host copy: ``a``
    may change as soon as this returns), and from there to the card with
    ``non_blocking`` on the current stream, where the step that reads the
    tensor runs. The allocator records an event on that copy and hands the
    block out again only once the event has passed, which it checks by
    query, never by waiting. Only a new block waits (``cudaHostAlloc``
    lets the card drain first): once the allocator holds blocks for the
    steps in flight, as after a loop's first log window, none is made. A
    tensor already on a card, and any placement on the CPU, go through
    ``torch.as_tensor`` as before (nothing is pinned)."""
    if device.type != "cuda" or (isinstance(a, torch.Tensor) and a.device.type == "cuda"):
        return torch.as_tensor(a, dtype=dtype, device=device)
    source = torch.as_tensor(a)
    staged = torch.empty(source.shape, dtype=dtype, pin_memory=True)
    staged.copy_(source)
    return staged.to(device, non_blocking=True)


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

    ``run_step`` replays a captured step (``step_kind``) on a card and
    steps eagerly on the CPU; each returns the step's metrics as tensors on
    the device, which are read on the host only at the log interval (and
    the loss-aware schedule sampler's losses, after every step). A step's
    inputs are placed with no host wait (``place``), so on a card
    ``run_step`` returns once the step is queued, as the JAX loop's
    asynchronous dispatch does, and the host draws the next batch while the
    card runs this one (a host two or three steps ahead waits in the graph
    launch, for room in the launch queue). The logged ``timing/step_time``
    (a log window's wall time over its steps, read before the flush's first
    device read) and ``timing/host_time`` are therefore host time per step,
    as in the JAX loop.
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
        self._programs = {}  # step shape -> TrainProgram
        self._pool = None  # their graph memory pool
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
        """Frames and masks of one step (numpy); with a codec, x0 is placed
        on the device (``place``) after the frames are chosen, encoded there
        and stays a tensor on the device."""
        x0, fi, obs, lat = sample_training_batch(
            self.host_rng, batch1, self.max_frames,
            batch2=batch2 if self.pad_with_random_frames else None,
            pad_with_random_frames=self.pad_with_random_frames)
        x0 = x0.astype(np.float32)
        if self.codec is not None:
            x0 = self.codec.encode(place(x0, torch.float32, self.device))
        return {"x0": x0, "frame_indices": fi, "obs_mask": obs, "latent_mask": lat}

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A prepared batch as tensors on the training device (``place``:
        on a card the host does not wait for the copies)."""
        return {name: place(batch[name], dtype, self.device)
                for name, dtype in BATCH_DTYPES.items()}

    def next_step_inputs(self):
        """Draw the next batch, its masks and its timesteps on the host, and
        place them on the training device (``place``). Returns (device
        batch, t, weights, t as numpy, weights as numpy)."""
        batch1 = self._next_batch()
        batch2 = self._next_batch() if self.pad_with_random_frames else batch1
        batch = self.to_device(self._prepare(batch1, batch2))
        t_np, w_np = self.schedule_sampler.sample(batch["x0"].shape[0], self.host_rng)
        t = place(t_np, torch.int64, self.device)
        w = place(w_np, torch.float32, self.device)
        return batch, t, w, t_np, w_np

    # ---- main loop ----

    @property
    def step_kind(self) -> str:
        """How ``run_step`` steps: "captured" (one CUDA graph per step shape,
        replayed once per step) on a card, with the model unwrapped, under
        DDP or under FSDP2; "eager" (``train_step``) on the CPU."""
        return "captured" if self.device.type == "cuda" else "eager"

    def _program_for(self, batch: Dict[str, torch.Tensor]):
        """The ``TrainProgram`` of this step's shape (B, K, image or latent
        size, microbatches), made at its first use; all of them share one
        graph memory pool."""
        from .graphs import TrainProgram

        key = (tuple(batch["x0"].shape), self.n_microbatches)
        program = self._programs.get(key)
        if program is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            program = self._programs[key] = TrainProgram(
                self.state, self.diffusion, batch, n_microbatches=self.n_microbatches,
                pad_with_random_frames=self.pad_with_random_frames, pool=self._pool)
        return program

    def run_step(self):
        t0 = time.time()
        batch, t, w, t_np, w_np = self.next_step_inputs()
        noise = draw_noise(self.generator, batch["x0"], self.n_microbatches)
        if self.step_kind == "captured":
            metrics = self._program_for(batch).run(batch, t, w, noise)
        else:
            metrics = train_step(self.state, batch, t, w, diffusion=self.diffusion, noise=noise,
                                 n_microbatches=self.n_microbatches,
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
        """Train until ``lr_anneal_steps`` or ``max_steps``, after printing
        (on rank 0) how the steps run (``step_kind``). SIGTERM and SIGINT
        request a checkpoint and a clean exit at the next step boundary
        (handlers are installed from the main thread only)."""
        import signal
        import threading

        if self.rank == 0:
            print(f"train step: {self.step_kind}" + (
                " (one CUDA graph per step shape, replayed once per step)"
                if self.step_kind == "captured" else ""))
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

