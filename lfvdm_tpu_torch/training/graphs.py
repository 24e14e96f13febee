"""Captured train steps (counterpart of the JAX loop's compiled step,
lfvdm_tpu/training/train_loop.py ``jax.jit(step_fn, donate_argnums=(0,))``).

JAX compiles the whole optimizer step once per input shape and runs it as
one device program on the state donated to it. Here one ``TrainProgram`` per
step shape (B, K, image or latent size, microbatches) holds a
``torch.cuda.CUDAGraph`` of one whole step, ``train_loop.step_body``:
q_sample, the U-Net forward with its three CUDA kernels (and their recompute
under ``use_checkpoint``), the backward, the weighted loss, the global
gradient norm and its finite flag, AdamW with its count and the LR anneal,
every EMA rate, and the select that leaves the state as it was on a
non-finite step. A replay reads nothing back to the host.

The state is the graph's as the donated buffers are JAX's: the parameters,
moments, counts and EMA copies are the ``TrainState``'s own tensors, which
each replay updates in place. ``TrainState.load_state_dict`` copies into
them in place, so a loaded or resumed state is what the next replay reads.
The gradients belong to the graph: its capture allocates them in its pool,
the program holds them, and each replay points the parameters' ``.grad`` at
them again (an eager step on the same state drops them).

What changes from step to step lives in static buffers the graph reads: the
batch (x0, frame_indices, obs_mask, latent_mask), ``t``, the weights and the
noise. The noise stays outside the graph: the loop draws it from its
generator in the eager step's order (one block per microbatch,
``train_loop.draw_noise``) and ``run`` copies it in, so captured steps are
the eager ones bit for bit. Dropout masks (p > 0) come from the model's own
generators, which the capture registers with the graph
(``CUDAGraph.register_generator_state``), so each replay draws the masks the
eager step would. A model that rematerialises blocks with dropout > 0 is
refused: its recompute sets its generator's state from the host, which a
graph cannot replay.

``run`` on a CUDA device replays the step's graph, or, at the program's first
step, runs the step eagerly on the device's capture stream (the warm-up, the
step's real run: the kernels build, cuDNN picks its algorithms) and captures
it there; both run with the program's device current. A capture executes
nothing, so the launch counts it adds are taken back and added again per
replay (``ops/_common.py``). A capture that fails raises: nothing falls back
to the eager step on the card. On the CPU ``run`` calls ``step_body``
eagerly on the same buffers. The metrics a replay writes are the graph's
outputs, overwritten by the next replay, and the CPU run keeps its metrics
in the same kind of static buffers: ``run`` returns clones (on the device,
with no sync) that later steps leave alone.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..models.unet import Dropout
from ..ops._common import add_launches, capture_graph
from ..parallel import sharding
from ..utils.device import current
from .train_loop import TrainState, step_body


class TrainProgram:
    """One optimizer step of one step shape on ``state``, captured on the
    card at its first step and replayed at every later one.

    ``batch``: a step's model inputs (x0, frame_indices, obs_mask,
    latent_mask) on the model's device; the static buffers take their
    shapes and dtypes. ``pool``: the graph memory pool the loop's programs
    share (they never run at once). The model must be unwrapped: under DDP
    or FSDP2 the loop steps eagerly."""

    def __init__(self, state: TrainState, diffusion, batch: Dict[str, torch.Tensor], *,
                 n_microbatches: int = 1, pad_with_random_frames: bool = True, pool=None):
        if sharding.unwrap(state.model) is not state.model or sharding.is_sharded(state.model):
            raise ValueError("a TrainProgram steps an unwrapped model; a wrapped one steps "
                             "eagerly (train_step)")
        x0 = batch["x0"]
        self.state, self.diffusion = state, diffusion
        self.n_microbatches, self.pad_with_random_frames = n_microbatches, pad_with_random_frames
        self.device = x0.device
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.t = torch.zeros(x0.shape[0], dtype=torch.int64, device=self.device)
        self.weights = torch.zeros(x0.shape[0], dtype=torch.float32, device=self.device)
        self.noise = torch.zeros_like(x0)
        self.pool = pool
        self.graph = None
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
            for name, buf in self.batch.items():
                buf.copy_(batch[name])
            self.t.copy_(t)
            self.weights.copy_(weights)
            self.noise.copy_(noise)
            if self.graph is not None:
                for p, g in zip(self.params, self.grads):
                    p.grad = g
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
        every replay adds. Raises if the model cannot be captured or the
        capture fails."""
        t0 = time.perf_counter()
        with current(self.device):
            self.diffusion.tables_on(self.device)
        graph, warm, outputs, delta = capture_graph(
            self._step, self.device, pool=self.pool,
            generators=_dropout_generators(self.state.model))
        self.graph, self.delta, self.outputs = graph, delta, outputs
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
    (the global one registers itself with every capture). Raises when a
    block that draws dropout masks is rematerialised."""
    generators = []
    for block in model.modules():
        if getattr(block, "use_checkpoint", False) and any(
                m.p > 0 for m in block.modules() if isinstance(m, Dropout)):
            raise NotImplementedError(
                "a captured train step cannot take dropout > 0 under use_checkpoint: the "
                "recompute sets the dropout generator's state from the host, which a CUDA "
                "graph does not replay")
    for m in model.modules():
        if isinstance(m, Dropout) and 0.0 < m.p < 1.0 and m.generator is not None:
            if not any(m.generator is g for g in generators):
                generators.append(m.generator)
    return generators
