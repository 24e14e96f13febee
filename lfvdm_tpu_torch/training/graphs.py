"""Captured train steps (counterpart of the JAX loop's compiled step,
lfvdm_tpu/training/train_loop.py ``jax.jit(step_fn, donate_argnums=(0,))``).

JAX compiles the whole optimizer step once per input shape and runs it as
one device program on the state donated to it, on one device or over a
(dp, fsdp) mesh with XLA's collectives inside. Here one ``TrainProgram`` per
step shape (B, K, image or latent size, microbatches) holds a
``torch.cuda.CUDAGraph`` of one whole step, ``train_loop.step_body``:
q_sample, the U-Net forward with its three CUDA kernels (and their recompute
under ``use_checkpoint``), the backward, the weighted loss, the global
gradient norm and its finite flag, AdamW with its count and the LR anneal,
every EMA rate, and the select that leaves the state as it was on a
non-finite step. Under DDP the graph holds the bucketed gradient
all-reduce on NCCL; under FSDP2 the all-gathers and reduce-scatters, the
all-reduce of the replicated parameters' gradients
(``sharding.sync_replicated_grads``) and the one inside the global norm
(``sharding.global_grad_norm``); under microbatches the chunks that do not
reduce and the last one that does. A replay reads nothing back to the host.

The state is the graph's as the donated buffers are JAX's: the parameters,
moments, counts and EMA copies are the ``TrainState``'s own tensors (under
FSDP2 each rank's local shards), which each replay updates in place.
``TrainState.load_state_dict`` copies into them in place, so a loaded or
resumed state is what the next replay reads. The gradients belong to the
graph: its capture allocates them in its pool, the program holds them, and
each replay points the parameters' ``.grad`` at them again (an eager step
on the same state drops them).

What changes from step to step lives in static buffers the graph reads: the
batch (x0, frame_indices, obs_mask, latent_mask), ``t``, the weights and the
noise. The noise stays outside the graph: the loop draws it from its
generator in the eager step's order (one block per microbatch,
``train_loop.draw_noise``) and ``run`` copies it in, so captured steps are
the eager ones bit for bit. Dropout masks (p > 0) come from the model's own
generators, which the capture registers with the graph
(``CUDAGraph.register_generator_state``), so each replay draws the masks the
eager step would; a rematerialised block's recompute draws its forward's
masks from a registered copy of the generator's state
(``models/unet.py`` ``RematDropoutStreams``).

``run`` on a CUDA device replays the step's graph, or, before it has one,
runs the step eagerly on the device's capture stream: first the program's
eager steps (``eager_steps_before_capture``), then the warm-up (the step's
real run: the kernels build, cuDNN picks its algorithms, FSDP2 runs its
lazy init), and captures the step there; all run with the program's device
current and are real steps of the state, so the run's trajectory is the
eager one. A capture executes nothing, so the launch counts it adds are
taken back and added again per replay (``ops/_common.py``). A capture that
fails raises: nothing falls back to the eager step on the card. On the CPU
``run`` calls ``step_body`` eagerly on the same buffers. The metrics a
replay writes are the graph's outputs, overwritten by the next replay, and
the CPU run keeps its metrics in the same kind of static buffers: ``run``
returns clones (on the device, with no sync) that later steps leave alone.

PyTorch documents four conditions for capturing a whole backward under DDP.
On torch 2.11 with NCCL 2.28.9 (``tools/group_capture_probe.py`` on an H100,
in a NCCL group of one):

- NCCL 2.9.6 or later: met by the toolkit's NCCL.
- DDP built in a side-stream context: needed. ``wrap_for_training`` builds
  DDP on the capture stream; built on the default stream, the capture was
  invalidated.
- At least 11 eager DDP iterations before the capture: needed, and the
  count is exact: after 10 the capture was invalidated
  (``DDP_EAGER_ITERATIONS``).
- The NCCL watchdog kept out of the capture (by
  ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` or a "thread_local" capture): not
  needed. Captures in the default "global" mode succeeded with the
  variable unset, for DDP and for FSDP2, so the group is joined as before.

FSDP2 needs only the warm-up: its lazy init runs there, and its hooks'
host state (which storages are resized, which events recorded) is what the
capture leaves and every replay finds.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..models.unet import Dropout, RematDropoutStreams
from ..ops._common import add_launches, capture_graph
from ..utils.device import current, on_capture_stream
from .train_loop import TrainState, step_body, train_step

# DDP's reducer times its first ten iterations (Reducer::
# should_collect_runtime_stats: iterations 1 to 10, then every 100th), and
# the forward after each timed one reads the timings back with a host sync
# (Logger::set_runtime_stats_and_log, CudaTimer::measureDifference): so 11
# eager iterations come before a capture.
DDP_EAGER_ITERATIONS = 11


def eager_steps_before_capture(model: torch.nn.Module) -> int:
    """How many eager steps a program on ``model`` runs on the card before the
    one it captures (whose warm-up is eager too): ``DDP_EAGER_ITERATIONS``
    in all under DDP; none for an unwrapped model or FSDP2, whose lazy init
    runs in the capture's warm-up."""
    from torch.nn.parallel import DistributedDataParallel

    return DDP_EAGER_ITERATIONS - 1 if isinstance(model, DistributedDataParallel) else 0


class TrainProgram:
    """One optimizer step of one step shape on ``state``, captured on the
    card after its eager steps and replayed at every later one.

    ``batch``: a step's model inputs (x0, frame_indices, obs_mask,
    latent_mask) on the model's device; the static buffers take their
    shapes and dtypes. ``pool``: the graph memory pool the loop's programs
    share (they never run at once). The model is unwrapped, DDP or FSDP2;
    in a group every rank runs its program in the same order, so the ranks
    capture at the same step and their replays' collectives match."""

    def __init__(self, state: TrainState, diffusion, batch: Dict[str, torch.Tensor], *,
                 n_microbatches: int = 1, pad_with_random_frames: bool = True, pool=None):
        x0 = batch["x0"]
        self.state, self.diffusion = state, diffusion
        self.n_microbatches, self.pad_with_random_frames = n_microbatches, pad_with_random_frames
        self.device = x0.device
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.t = torch.zeros(x0.shape[0], dtype=torch.int64, device=self.device)
        self.weights = torch.zeros(x0.shape[0], dtype=torch.float32, device=self.device)
        self.noise = torch.zeros_like(x0)
        self.pool = pool
        self.eager_steps = (eager_steps_before_capture(state.model)
                            if self.device.type == "cuda" else 0)
        self.eager_steps_run = 0
        self.graph = None
        self.streams = None  # the rematerialised blocks' dropout state copies
        self.delta = {}  # launch counts one replay adds (ops launch_snapshot keys)
        self.capture_s = None  # seconds of warm-up and capture
        self.outputs = None  # the step's metrics, as the graph (or the CPU run) writes them
        self.params: List[torch.Tensor] = []
        self.grads: List[torch.Tensor] = []  # the graph's gradient buffers

    def run(self, batch, t, weights, noise) -> Dict[str, torch.Tensor]:
        """One step on ``batch``, ``t``, ``weights`` and ``noise`` (the
        step's draws, x0's shape), on the program's device; advances
        ``state.step``. Returns the step's metrics, tensors on the device
        that no later step overwrites."""
        with current(self.device):
            if self.graph is None and self.eager_steps_run < self.eager_steps:
                self.eager_steps_run += 1
                with on_capture_stream(self.device):
                    return train_step(self.state, batch, t, weights, diffusion=self.diffusion,
                                      noise=noise, n_microbatches=self.n_microbatches,
                                      pad_with_random_frames=self.pad_with_random_frames)
            for name, buf in self.batch.items():
                buf.copy_(batch[name])
            self.t.copy_(t)
            self.weights.copy_(weights)
            self.noise.copy_(noise)
            if self.graph is not None:
                for p, g in zip(self.params, self.grads):
                    p.grad = g
                self.streams.before_replay()
                self.graph.replay()
                add_launches(self.delta)
            elif self.device.type == "cuda":
                warm = self.capture()
                self.state.step += 1
                return warm
            else:
                metrics = self._step()
                if self.outputs is None:
                    self.outputs = metrics
                else:
                    for name, out in self.outputs.items():
                        out.copy_(metrics[name])
            self.state.step += 1
            return {name: out.clone() for name, out in self.outputs.items()}

    def capture(self) -> Dict[str, torch.Tensor]:
        """Run this step (already in the buffers) eagerly on the device's
        capture stream, the warm-up, then capture it there, with the
        program's device current. The warm-up is the step's real execution
        and its metrics are returned; the capture executes nothing, so the
        launch counts it adds are taken back and kept as ``delta``, which
        every replay adds. Raises if the capture fails."""
        t0 = time.perf_counter()
        with current(self.device):
            self.diffusion.tables_on(self.device)
        generators = _dropout_generators(self.state.model)
        streams = RematDropoutStreams(generators)

        def step():
            with streams.watch(self.state.model):
                return self._step()

        graph, warm, outputs, delta = capture_graph(
            step, self.device, pool=self.pool,
            generators=lambda: generators + streams.copies())
        self.graph, self.streams, self.delta, self.outputs = graph, streams, delta, outputs
        self.params = [p for _, p in self.state.named_params()]
        self.grads = [p.grad for p in self.params]
        self.capture_s = time.perf_counter() - t0
        return warm

    def _step(self) -> Dict[str, torch.Tensor]:
        return step_body(self.state, self.batch, self.t, self.weights, diffusion=self.diffusion,
                         noise=self.noise, n_microbatches=self.n_microbatches,
                         pad_with_random_frames=self.pad_with_random_frames)


def _dropout_generators(model: torch.nn.Module) -> List[torch.Generator]:
    """The explicit generators ``model``'s dropout draws from in training
    (the global one registers itself with every capture)."""
    generators = []
    for m in model.modules():
        if isinstance(m, Dropout) and 0.0 < m.p < 1.0 and m.generator is not None:
            if not any(m.generator is g for g in generators):
                generators.append(m.generator)
    return generators
