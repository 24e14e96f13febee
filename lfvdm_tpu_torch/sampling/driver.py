"""Long-video sampler driver (counterpart of lfvdm_tpu/sampling/driver.py).

Iterate a sampling scheme, gather each window's conditioning frames, run the
reverse diffusion over the K-frame window (ancestral, DDIM or DPM-Solver++),
and scatter the generated frames back into the video buffer. Windows run at
their exact size: the attention pre-norm statistics include every frame of a
window, so padding would perturb real frames.

Sampling happens in diffusion space; with a ``codec`` (``diffusion/codecs.py``)
the assembled video is decoded once at the end (to pixels through the VAE in
latent space, out of the subbands in wavelet space).

``devices`` samples each window over several devices of one process (the
counterpart of the JAX driver's mesh): one replica of the model per device,
each window's batch split into contiguous blocks of rows, one per device,
the results put back in row order. Each replica draws the noise of the whole
batch from its own copy of the caller's generator and keeps its rows, so
the samples are the one-device sampler's. The replicas run in turn from one
thread: their launches are asynchronous and a window makes no host sync, so
a card computes while the host enqueues the next card's window, with none of
the launch-counter races and per-thread device state that a thread per card
would bring.

Each window runs as a program made once per (replica, window shape)
(``_sampler_for``, the counterpart of the JAX driver's per-shape memo of
compiled samplers; ``sampling/graphs.py``): on a CUDA device a CUDA graph
of one reverse step, captured at the first window of its shape and
replayed once per diffusion step; on the CPU the same step run eagerly on
the program's buffers. A scheme's tail window (a K below ``max_frames``)
gets a program of its own. ``graphs=False`` runs the eager loops of
``diffusion/gaussian.py`` and ``dpm_solver.py`` instead.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from ..diffusion.dpm_solver import dpm_solver_pp_sample_loop
from ..diffusion.gaussian import GaussianDiffusion
from ..parallel.sharding import row_blocks
from ..utils import tracing
from ..utils.device import process_index_and_count
from .graphs import WindowProgram, eval_mode
from .schemes import sampling_schemes


class VideoSampler:
    """Samples windows and long videos with ``model`` (an ``nn.Module`` on
    the sampling device) under ``diffusion``; ``codec`` decodes a sampled
    video out of diffusion space. ``devices``: sample each window's rows
    over these devices (see the module docstring); ``model`` moves to the
    first, and the others get copies. ``model_calls`` counts every
    replica's calls. ``graphs``: run each window as a program memoized per
    replica and shape (a CUDA graph of one step on the card, see the module
    docstring); False runs the eager loops, the reference the programs are
    held to."""

    def __init__(self, model: torch.nn.Module, diffusion: GaussianDiffusion, *,
                 clip_denoised: bool = True, use_ddim: bool = False, use_dpm: bool = False,
                 eta: float = 0.0, encoder_reuse: int = 1, codec=None,
                 devices: Optional[Sequence[torch.device]] = None, graphs: bool = True):
        if use_ddim and use_dpm:
            raise ValueError("pick one of use_ddim / use_dpm")
        # Encoder reuse (arXiv:2312.09608): the U-Net's down and middle path
        # run every encoder_reuse-th step, the up path alone in between.
        # Approximate; the ancestral sampler only.
        if encoder_reuse < 1:
            raise ValueError(f"encoder_reuse must be >= 1, got {encoder_reuse}")
        if encoder_reuse > 1 and (use_ddim or use_dpm):
            raise ValueError("encoder_reuse supports the ancestral sampler only")
        if devices is not None and len(devices) > 1 and process_index_and_count()[1] > 1:
            raise ValueError("sampling over devices supports one process; under a launcher "
                             "each process samples its own share of the videos")
        if devices:
            model = model.to(devices[0])
        self.model = model
        self.replicas = [model] + [copy.deepcopy(model).to(d) for d in (devices or [])[1:]]
        self._warned_tail = set()
        self.diffusion = diffusion
        self.codec = codec
        self.device = next(model.parameters()).device
        self.clip_denoised = clip_denoised
        self.use_ddim = use_ddim
        self.use_dpm = use_dpm
        self.eta = eta
        self.encoder_reuse = int(encoder_reuse)
        self.model_calls = 0  # U-Net forwards run by this sampler
        self.reuse_calls = 0  # of which up-path-only calls on cached features
        self.graphs = graphs
        self._programs = {}  # (replica, device, input shapes) -> WindowProgram
        self._pools = {}  # device -> the graph memory pool its programs share

    def _model_fn(self, model):
        def fn(x, ts, **kw):
            self.model_calls += 1
            out, _ = model(x, ts, **kw)
            return out

        return fn

    def _model_fn_attn(self, x, ts, **kw):
        self.model_calls += 1
        return self.model(x, ts, return_attn_weights=True, **kw)

    def _model_fn_features(self, model, kwargs):
        """``model_fn_features(x, t, features)`` with ``kwargs`` bound."""

        def fn(x, ts, feats):
            self.model_calls += 1
            self.reuse_calls += feats is not None
            out, _, feats = model(x, ts, features=feats, return_features=True, **kwargs)
            return out, feats

        return fn

    def _window_args(self, x0, frame_indices, obs_mask, latent_mask, dev=None):
        """The model kwargs of one window on ``dev`` (default: the sampler's
        device), and its shape."""
        dev = dev or self.device
        with tracing.span("driver.upload"):
            x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
            kwargs = dict(
                x0=x0,
                frame_indices=torch.as_tensor(frame_indices, dtype=torch.int64, device=dev),
                obs_mask=torch.as_tensor(obs_mask, dtype=torch.float32, device=dev),
                latent_mask=torch.as_tensor(latent_mask, dtype=torch.float32, device=dev),
            )
        if tracing.enabled():
            tracing.count("driver.h2d_bytes", sum(v.nbytes for v in kwargs.values()))
        return kwargs, tuple(x0.shape)

    @torch.no_grad()
    def sample_window(self, x0, frame_indices, obs_mask, latent_mask, *, generator=None,
                      noise=None, step_noise=None) -> torch.Tensor:
        """Run the reverse process for one K-frame window.

        Arrays may be numpy or tensors; they are moved to the sampler's
        device. ``generator`` (on that device) draws the noise, or pass the
        terminal ``noise`` and, for the ancestral sampler, each step's
        ``step_noise``. Returns a (B, K, C, H, W) f32 tensor on the sampler's
        device, the caller's own (not a program's buffer).
        """
        B, n = len(x0), len(self.replicas)
        if n == 1 or B % n:
            if n > 1 and B not in self._warned_tail:
                self._warned_tail.add(B)
                print(f"sample_window: batch {B} not divisible by the {n} devices; running "
                      "replicated")
            return self._window(0, x0, frame_indices, obs_mask, latent_mask, generator, noise,
                                step_noise)
        start = generator.get_state() if generator is not None else None
        outs = []
        for replica, (model, rows) in enumerate(zip(self.replicas, row_blocks(B, n))):
            dev = next(model.parameters()).device
            gen = None
            if generator is not None:
                gen = torch.Generator(device=dev)
                gen.set_state(start)
            draw = _full_batch_draws((B,) + tuple(x0.shape[1:]), gen, dev)
            rows_noise = noise[rows].to(dev) if noise is not None else draw(None)[rows]
            rows_steps = _Rows(step_noise.__getitem__ if step_noise is not None else draw,
                               rows, dev)
            part = [a[rows] for a in (x0, frame_indices, obs_mask, latent_mask)]
            outs.append(self._window(replica, *part, None, rows_noise, rows_steps))
        if generator is not None:
            generator.set_state(gen.get_state())  # where the one-device window leaves it
        return torch.cat([o.to(self.device) for o in outs])

    def _mode(self) -> str:
        if self.use_ddim:
            return "ddim"
        if self.use_dpm:
            return "dpm"
        return "reuse" if self.encoder_reuse > 1 else "ancestral"

    def _sampler_for(self, replica: int, window, mode: Optional[str] = None) -> WindowProgram:
        """The program of ``replica`` for this window's input shapes, made at
        the first window of those shapes (JAX's ``_sampler_for``, memoized
        per call shape). ``mode="attn"``: the heatmap sampler's program,
        memoized apart under an "attn" tag (JAX's ``("attn",) + shape``)."""
        dev = window["x0"].device
        key = (replica, str(dev)) + tuple(tuple(v.shape) for v in window.values())
        if mode == "attn":
            key = ("attn",) + key
        program = self._programs.get(key)
        if program is None:
            pool = None
            if dev.type == "cuda":
                pool = self._pools.get(dev)
                if pool is None:
                    pool = self._pools[dev] = torch.cuda.graph_pool_handle()
            program = self._programs[key] = WindowProgram(
                self.replicas[replica], self.diffusion, window, mode=mode or self._mode(),
                eta=self.eta, clip_denoised=self.clip_denoised,
                encoder_reuse=self.encoder_reuse, owner=self, pool=pool)
        return program

    def _window(self, replica, x0, frame_indices, obs_mask, latent_mask, generator, noise,
                step_noise):
        """One window on replica ``replica``'s device."""
        model = self.replicas[replica]
        dev = next(model.parameters()).device
        kwargs, shape = self._window_args(x0, frame_indices, obs_mask, latent_mask, dev)
        if self.graphs:
            return _run_program(self._sampler_for(replica, kwargs), kwargs, shape, generator,
                                noise, step_noise)
        common = dict(device=dev, noise=noise, generator=generator,
                      clip_denoised=self.clip_denoised, model_kwargs=kwargs)
        model_fn = self._model_fn(model)
        with eval_mode(model):
            if self.use_ddim:
                return self.diffusion.ddim_sample_loop(model_fn, shape, eta=self.eta,
                                                       step_noise=step_noise, **common)
            if self.use_dpm:
                return dpm_solver_pp_sample_loop(self.diffusion, model_fn, shape, **common)
            return self.diffusion.p_sample_loop(
                model_fn, shape, step_noise=step_noise, encoder_reuse=self.encoder_reuse,
                model_fn_features=self._model_fn_features(model, kwargs), **common)

    @torch.no_grad()
    def sample_window_attn(self, x0, frame_indices, obs_mask, latent_mask, *, generator=None,
                           noise=None, step_noise=None):
        """``sample_window`` with the reference's per-quartile attention
        heatmaps: returns (sample, {"attn/q{q}-temporal": (B, K, K),
        "attn/q{q}-spatial": (B, S, S)}) (``GaussianDiffusion.p_sample_loop``
        with ``return_attn_weights``). The exact ancestral sampler only. The
        attention weights come from the attention blocks' einsum form, so
        this path launches no attention kernel; the up path's skip
        projections still launch theirs. Runs through the program memoized
        for the window's shapes under an "attn" tag (on the card a CUDA graph
        of one step, the maps summed into its static accumulators); with
        ``graphs=False``, the eager loop."""
        if self.use_ddim or self.use_dpm or self.encoder_reuse != 1:
            raise ValueError("sample_window_attn runs the exact ancestral sampler; it cannot "
                             "honor use_ddim, use_dpm or encoder_reuse > 1")
        kwargs, shape = self._window_args(x0, frame_indices, obs_mask, latent_mask)
        if self.graphs:
            program = self._sampler_for(0, kwargs, mode="attn")
            img = _run_program(program, kwargs, shape, generator, noise, step_noise)
            return img, program.attn_maps()
        with eval_mode(self.model):
            return self.diffusion.p_sample_loop(
                self._model_fn_attn, shape, device=self.device, noise=noise,
                generator=generator, step_noise=step_noise, clip_denoised=self.clip_denoised,
                model_kwargs=kwargs, return_attn_weights=True)

    def sample_video(self, batch: np.ndarray, *, scheme_name: str, n_obs: int, max_frames: int,
                     step_size: int, generator: torch.Generator,
                     optimal_schedule: Optional[dict] = None, embedder=None,
                     just_get_indices: bool = False, verbose: bool = False):
        """Generate a full video given its first ``n_obs`` frames.

        ``batch``: (B, T, C, H, W) ground-truth videos in diffusion space
        (only the first n_obs frames are read unless ``just_get_indices``).
        Returns (samples numpy, indices_used list). With a codec the
        assembled video is uploaded to the sampler's device once and
        decoded there (unless ``just_get_indices``), so the samples are in
        pixel space, (B, T, 3, H', W') for the latent codecs.
        """
        B, T, C, H, W = batch.shape
        samples = np.zeros_like(batch)
        samples[:, :n_obs] = batch[:, :n_obs]

        kwargs = dict(video_length=T, num_obs=n_obs, max_frames=max_frames,
                      step_size=step_size, optimal_schedule=optimal_schedule)
        if scheme_name.startswith("adaptive"):
            kwargs.update(embedder=embedder, device=self.device)
        scheme = iter(sampling_schemes[scheme_name](**kwargs))

        indices_used = []
        while True:
            with tracing.span("driver.plan"):
                scheme.set_videos(samples)
                planned = next(scheme, None)
            if planned is None:
                break
            obs_idx, latent_idx = planned
            if not isinstance(obs_idx[0], (list, np.ndarray)):
                obs_idx = [list(obs_idx)] * B
                latent_idx = [list(latent_idx)] * B
            if verbose:
                print(f"conditioning on {sorted(obs_idx[0])}, "
                      f"generating {sorted(latent_idx[0])}")

            with tracing.span("driver.gather"):
                frame_indices = np.concatenate(
                    [np.asarray(obs_idx, np.int64).reshape(B, -1),
                     np.asarray(latent_idx, np.int64).reshape(B, -1)], axis=1)  # (B, K)
                K = frame_indices.shape[1]
                x0 = np.stack([samples[b, frame_indices[b]] for b in range(B)])
                obs_mask = np.zeros((B, K, 1, 1, 1), np.float32)
                obs_mask[:, : len(obs_idx[0])] = 1.0
                latent_mask = 1.0 - obs_mask

            if just_get_indices:
                local = np.stack([batch[b, frame_indices[b]] for b in range(B)])
            else:
                local = _download(self.sample_window(x0, frame_indices, obs_mask, latent_mask,
                                                     generator=generator))
            with tracing.span("driver.scatter"):
                n_latent = len(latent_idx[0])
                for b in range(B):
                    samples[b, latent_idx[b]] = local[b, -n_latent:]
            indices_used.append((obs_idx, latent_idx))
        if self.codec is not None and not just_get_indices:
            with tracing.span("driver.upload"):
                video = torch.as_tensor(samples, device=self.device)
            tracing.count("driver.h2d_bytes", samples.nbytes)
            samples = _download(self.codec.decode(video))
        return samples, indices_used


def _download(out: torch.Tensor) -> np.ndarray:
    """``out`` on the host as numpy. While the recorder is on, the wait for
    the card (which ``.cpu()`` makes anyway) is a span of its own."""
    if tracing.enabled() and out.device.type == "cuda":
        with tracing.span("driver.wait"):
            torch.cuda.synchronize(out.device)
    with tracing.span("driver.download"):
        local = out.cpu().numpy()
    tracing.count("driver.d2h_bytes", local.nbytes)
    return local


def _run_program(program: WindowProgram, kwargs, shape, generator, noise, step_noise):
    """A window through its program: the terminal noise, then per step that
    step's noise (drawn in the eager loop's order) and one run. Returns the
    caller's own copy of the state."""
    draw = _full_batch_draws(shape, generator, program.device)
    with tracing.span("window.load"):
        program.load(kwargs, noise if noise is not None else draw(None))
    with tracing.span("window.steps"):
        for i in range(program.steps):
            step = None
            if program.noise is not None:
                step = step_noise[i] if step_noise is not None else draw(i)
            program.run(i, step)
    tracing.count("window.replays", program.steps)
    return program.x.clone()


def _full_batch_draws(shape, generator, device):
    """``draw(i)``: the next noise of the whole batch from ``generator``."""

    def draw(i):
        if generator is None:
            raise ValueError("pass noise= or a torch.Generator on the sampling device")
        return torch.randn(shape, generator=generator, device=device)

    return draw


class _Rows:
    """Step noise for one replica: step ``i``'s noise of the whole batch
    (``source(i)``, called once per step in step order) cut to ``rows``, on
    ``device``."""

    def __init__(self, source, rows: slice, device):
        self.source, self.rows, self.device = source, rows, device

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.source(i)[self.rows].to(self.device)
