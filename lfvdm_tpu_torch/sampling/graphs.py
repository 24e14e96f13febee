"""Captured window programs (counterpart of the JAX driver's per-shape compiled
sampler, lfvdm_tpu/sampling/driver.py ``VideoSampler._sampler_for``).

JAX compiles a window's whole reverse trajectory once per call shape and
runs it as one device program. Here one ``WindowProgram`` per (replica,
window shape) holds a ``torch.cuda.CUDAGraph`` of ONE reverse step, replayed
once per diffusion step: a graph of the whole window would unroll 50-1000
copies of a ~700-node forward. The graph holds every launch of the U-Net
forward (the three CUDA kernels among them) and the sampler's update.

What changes from step to step lives on the device, in static buffers the
graph reads: the state ``x``, the step index ``i`` (a 0-d int64 tensor from
which the step reads its timestep in ``GaussianDiffusion.step_timesteps``,
and DPM-Solver++ its coefficient row) and the step's ``noise``. The window's
model inputs (``kwargs``: x0, frame_indices, obs_mask, latent_mask) are
static buffers too, loaded once per window (``load``). DPM-Solver++ keeps its
previous x0 estimate in ``x0_prev``. Under encoder reuse the program holds
two graphs, the full call and the reuse call, and the full graph's feature
outputs are the buffer the reuse graph reads. The heatmap sampler's program
(mode "attn", JAX's ``("attn",) + shape`` entry) sums each step's attention
maps into static quartile accumulators (``acc``), at the quartile the step
reads on the device from ``i``; they are made at the first step, outside
the pool, and zeroed by each ``load``.

Noise stays outside the graph: the caller draws it from its own
``torch.Generator`` in the eager loop's order (the terminal noise, then one
draw per step) and ``run`` copies it in, so captured samples are the eager
sampler's, bit for bit, with no graph-safe generator state to register.

``run(i, noise)`` on a CUDA device replays the step's graph, or, the first
time a graph is needed, runs the step eagerly on the device's capture
stream (the warm-up: the kernels build on first use, set their
shared-memory attributes, and cuDNN picks its algorithms) and captures it
there (``capture``, through ``ops/_common.py`` ``capture_graph``). Both
run with the program's device current, and the capture stream is one made
on that device: a replica on a second card captures its own step, never an
empty graph on another card's stream. A capture that fails raises: nothing
falls back to the eager loop on the card. On the CPU ``run`` calls the same
step eagerly on the same buffers.
Every ``run`` adds one model call (or reuse call) to its owner's counters,
and a replay adds the launch counts its graph's capture recorded to the
kernels' counters (``ops/_common.py`` ``add_launches``), so those go on
counting the kernels the card executes.

All programs of one sampler share one graph memory pool per device
(``torch.cuda.graph_pool_handle``): they never run at once, and the static
buffers lie outside the pool. Only the features a full graph holds under
encoder reuse live in it, and they may share memory with an earlier
program's temporaries; each window starts with a full call, which rewrites
them before its reuse calls read them, so another program's replays
between windows cannot reach them. A program's state is overwritten by its
next window: copy ``x`` out before then.
"""

from __future__ import annotations

import contextlib
import time
import weakref

import torch

from ..diffusion.dpm_solver import dpm_solver_pp_rows, dpm_solver_pp_step
from ..diffusion.gaussian import _combined_spatial, _quartile_accumulators, step_timestep
from ..ops._common import add_launches, capture_graph
from ..utils.device import current

MODES = ("ancestral", "ddim", "dpm", "reuse", "attn")


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """Run ``model`` in eval mode inside (as JAX samples with train=False),
    and put its mode back after."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


class WindowProgram:
    """The reverse step of one window shape on ``model``'s device, captured
    (on the card) per kind of call: "full", and under ``mode="reuse"`` also
    "reuse" (the up path on the cached features).

    ``window``: the model inputs of a window (x0, frame_indices, obs_mask,
    latent_mask), on the model's device; the static buffers take their
    shapes and dtypes. ``mode``: "ancestral", "ddim" (with ``eta``), "dpm",
    "reuse" (ancestral with ``encoder_reuse`` = k > 1) or "attn" (ancestral,
    with the attention heatmaps of ``p_sample_loop(return_attn_weights=True)``
    summed per quartile of the steps into ``acc``). ``owner``: the
    object whose ``model_calls`` and ``reuse_calls`` each ``run`` counts
    (held weakly). ``pool``: the graph memory pool the captures share."""

    def __init__(self, model, diffusion, window, *, mode: str, eta: float = 0.0,
                 clip_denoised: bool = True, encoder_reuse: int = 1, owner=None, pool=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.model, self.diffusion, self.mode = model, diffusion, mode
        self.eta, self.clip_denoised, self.encoder_reuse = eta, clip_denoised, encoder_reuse
        x0 = window["x0"]
        self.device = x0.device
        self.shape = tuple(x0.shape)
        self.kwargs = {k: torch.empty_like(v) for k, v in window.items()}
        self.x = torch.zeros(self.shape, dtype=torch.float32, device=self.device)
        self.i = torch.zeros((), dtype=torch.int64, device=self.device)
        takes_noise = mode in ("ancestral", "reuse", "attn") or (mode == "ddim" and eta != 0.0)
        self.noise = torch.zeros_like(self.x) if takes_noise else None
        self.ts = diffusion.step_timesteps(self.device)
        if mode == "dpm":
            self.rows = dpm_solver_pp_rows(diffusion, self.device)
            self.x0_prev = torch.zeros_like(self.x)
        if mode == "attn":
            # Step i's quartile, q = (4 t) // N at its timestep t, read on
            # the device from i as the timestep is.
            self.quartiles = (4 * self.ts) // diffusion.num_timesteps
        self.acc = None  # the (4, B, T, T) and (4, B, S, S) f32 heatmap sums
        self.features = None
        self.pool = pool
        self._owner = weakref.ref(owner) if owner is not None else None
        self.graphs = {}      # kind -> CUDAGraph
        self.deltas = {}      # kind -> launch counts one replay adds (ops launch_snapshot keys)
        self.capture_s = {}   # kind -> seconds of warm-up and capture

    @property
    def steps(self) -> int:
        """Model calls per window."""
        return self.diffusion.num_timesteps

    def kind(self, i: int) -> str:
        """The call step ``i`` makes: "reuse" off every k-th step under
        encoder reuse, else "full"."""
        return "reuse" if self.mode == "reuse" and i % self.encoder_reuse else "full"

    def load(self, window, noise):
        """Start a window: its model inputs and its terminal ``noise`` into
        the static buffers."""
        for name, buf in self.kwargs.items():
            buf.copy_(window[name])
        self.x.copy_(noise)
        if self.mode == "dpm":
            self.x0_prev.zero_()
        if self.acc is not None:
            for acc in self.acc:
                acc.zero_()

    def attn_maps(self):
        """The window's heatmaps as ``p_sample_loop(return_attn_weights=True)``
        returns them ({"attn/q{q}-temporal": (B, T, T), "attn/q{q}-spatial":
        (B, S, S)}), the caller's own tensors."""
        return {f"attn/q{q}-{kind}": acc[q].clone() for q in range(4)
                for kind, acc in zip(("temporal", "spatial"), self.acc)}

    def run(self, i: int, noise=None):
        """Step ``i`` of the window (0 is the noisiest), with that step's
        ``noise`` where the sampler takes one."""
        kind = self.kind(i)
        launches = {}
        with current(self.device):
            self.i.fill_(i)
            if self.noise is not None:
                self.noise.copy_(noise)
            if kind in self.graphs:
                self.graphs[kind].replay()
                launches = self.deltas[kind]
            elif self.device.type == "cuda":
                self.capture(kind)
            else:
                with torch.no_grad(), eval_mode(self.model):
                    features = self._step(kind)
                if kind == "full" and self.mode == "reuse":
                    self.features = features
        add_launches(launches)
        owner = self._owner() if self._owner is not None else None
        if owner is not None:
            owner.model_calls += 1
            owner.reuse_calls += kind == "reuse"

    def capture(self, kind: str):
        """Run this step (already in the buffers) and capture it into the
        graph of ``kind`` (``ops/_common.py`` ``capture_graph``: the
        warm-up on the device's capture stream is the step's real
        execution; a replay adds the launch counts the capture took back).
        Raises if the capture fails or the device is no CUDA device."""
        t0 = time.perf_counter()
        with current(self.device):
            self.diffusion.tables_on(self.device)
        with torch.no_grad(), eval_mode(self.model):
            graph, warm, captured, delta = capture_graph(
                lambda: self._step(kind), self.device, pool=self.pool)
        if kind == "full" and self.mode == "reuse":
            # The graph's feature outputs are the reuse graph's input; they
            # take the warm-up's values, as if the graph had run.
            with current(self.device):
                for dst, src in zip(_tensors(captured), _tensors(warm)):
                    dst.copy_(src)
            self.features = captured
        self.graphs[kind], self.deltas[kind] = graph, delta
        self.capture_s[kind] = time.perf_counter() - t0

    def _call(self, x, ts, **kwargs):
        return self.model(x, ts, **kwargs)[0]

    def _call_attn(self, x, ts, **kwargs):
        return self.model(x, ts, return_attn_weights=True, **kwargs)

    def _accumulate(self, attns):
        """Add this step's maps, over the quarter of the steps, into the
        accumulators' row of its quartile: the eager loop's ``acc[q] +=
        maps / quarter`` (``p_sample_loop``), with q read on the device, as
        one ``index_add_`` of one row (one rounding per element, as ``+=``).
        The accumulators are made at the first step, outside any graph."""
        if self.acc is None:
            self.acc = _quartile_accumulators(attns, self.shape[0], self.device)
        quarter = self.diffusion.num_timesteps / 4.0
        q = self.quartiles.index_select(0, self.i.reshape(1))
        temporal = sum(a.float() for a in attns["temporal"]) / quarter
        spatial = _combined_spatial(attns["spatial"], self.acc[1].shape[-1]) / quarter
        self.acc[0].index_add_(0, q, temporal.unsqueeze(0))
        self.acc[1].index_add_(0, q, spatial.unsqueeze(0))

    def _call_features(self, x, ts, features):
        out, _, features = self.model(x, ts, features=features, return_features=True,
                                      **self.kwargs)
        return out, features

    def _step(self, kind: str):
        """One reverse step on the buffers: reads x, i, noise and the window
        inputs, writes x (and x0_prev). Returns the features of a full call
        under encoder reuse, else None."""
        d, x = self.diffusion, self.x
        t = step_timestep(self.ts, self.i, self.shape[0])
        common = dict(clip_denoised=self.clip_denoised)
        features = None
        if self.mode == "dpm":
            row = self.rows.index_select(0, self.i.reshape(1))[0]
            new, x0 = dpm_solver_pp_step(d, self._call, x, self.x0_prev, t, row,
                                         model_kwargs=self.kwargs, **common)
            self.x0_prev.copy_(x0)
        elif self.mode == "ddim":
            new = d.ddim_sample(self._call, x, t, eta=self.eta, noise=self.noise,
                                model_kwargs=self.kwargs, **common)["sample"]
        elif self.mode == "ancestral":
            new = d.p_sample(self._call, x, t, noise=self.noise, model_kwargs=self.kwargs,
                             **common)["sample"]
        elif self.mode == "attn":
            out, attns = d.call_model(self._call_attn, x, t, self.kwargs)
            self._accumulate(attns)
            pmv = d.p_mean_variance_from_output(out, x, t, **common)
            new = d._ancestral_update(pmv, x, t, self.noise, None)
        else:
            new, features = d.p_sample_features(
                self._call_features, x, t, None if kind == "full" else self.features,
                noise=self.noise, **common)
        x.copy_(new)
        return features


def _tensors(features):
    """The tensors of a U-Net features tuple ``(h, skips)``, in order."""
    h, skips = features
    return [h, *skips]
