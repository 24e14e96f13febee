"""Ahead-of-time export of the window sampler for serving (counterpart of
lfvdm_tpu/serving.py).

The deployment unit is one K-frame window of the reverse diffusion at a
fixed (B, K, C, H, W) shape. ``export_window_sampler`` traces ONE reverse
step ``(params, x_t, t, noise, x0, frame_indices, obs_mask, latent_mask) ->
x_{t-1}`` with ``torch.export`` (the U-Net applied through
``torch.func.functional_call``, so the weights stay an argument and the
artifact holds none; the respaced schedule tables are constants of the
graph, on the export device) and serialises it. Where JAX exports a
``lax.scan`` over the steps, ``torch.export`` would unroll a Python loop into
one copy of the U-Net per step, so the timestep is a tensor input and one
graph serves every step. The kernels appear in the graph as the operators
``torch.ops.lfvdm.*``, which importing this module registers.

A serving process needs only torch, this module, the package's ``ops``
(the kernels) and ``utils/device.py``: ``load_window_sampler`` deserialises
the artifact and runs the step from ``num_timesteps - 1`` down to 0,
drawing the initial and each step's noise from a ``torch.Generator`` seeded
by the call's seed, in step order, on the artifact's device. On the card
the step is captured once as a CUDA graph and replayed at every step
(``ServedWindow``), where JAX calls ``jax.jit(exported.call)``. No model,
config, diffusion or sampling code is imported, at load time or at call
time. Weights ship separately (``save_params_npz`` / ``load_params_npz``)
and stay an argument of every call, so EMA rates can be swapped.

Like the JAX module, this covers the ancestral and DDIM samplers.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
import zipfile
from typing import Mapping

import numpy as np
import torch

from . import ops  # noqa: F401  (registers torch.ops.lfvdm.*, which the artifact calls)
from .ops._common import add_launches, capture_graph
from .utils import tracing
from .utils.device import current as _current

META = "lfvdm_window_sampler.json"  # the artifact's extra file
BF16_KEYS = "__bfloat16__"  # params.npz: the leaves stored as bf16 bits (uint16)


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    """``model`` in eval mode inside (dropout off, as JAX samples with
    train=False), its mode put back after. The sampling driver has its own:
    this module imports no sampling code."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


def _model_fn(model, params):
    def fn(x, ts, **kw):
        out, _ = torch.func.functional_call(model, params, (x, ts), kw)
        return out

    return fn


def make_window_sampler(model, diffusion, *, use_ddim: bool = False, eta: float = 0.0,
                        clip_denoised: bool = True):
    """The pure ``(params, x0, frame_indices, obs_mask, latent_mask, seed) ->
    window`` function: ``params`` is a state dict applied to ``model``
    through ``functional_call``; the noise comes from a ``torch.Generator``
    on x0's device seeded by ``seed`` (or ``noise=`` and, for the ancestral
    sampler, ``step_noise=``, in step order)."""

    def fn(params, x0, frame_indices, obs_mask, latent_mask, seed, *, noise=None,
           step_noise=None):
        kwargs = dict(x0=x0, frame_indices=frame_indices, obs_mask=obs_mask,
                      latent_mask=latent_mask)
        common = dict(device=x0.device, noise=noise, clip_denoised=clip_denoised,
                      generator=torch.Generator(device=x0.device).manual_seed(int(seed)),
                      model_kwargs=kwargs)
        model_fn = _model_fn(model, params)
        with torch.no_grad(), _eval_mode(model):
            if use_ddim:
                return diffusion.ddim_sample_loop(model_fn, tuple(x0.shape), eta=eta, **common)
            return diffusion.p_sample_loop(model_fn, tuple(x0.shape), step_noise=step_noise,
                                           **common)

    return fn


class _Step(torch.nn.Module):
    """One reverse step. The model and diffusion are kept out of the module
    tree, so that ``torch.export`` lifts no weights: every parameter reaches
    the U-Net through ``params``."""

    def __init__(self, model, diffusion, use_ddim, eta, clip_denoised):
        super().__init__()
        self._parts = (model, diffusion)
        self.use_ddim, self.eta, self.clip_denoised = use_ddim, eta, clip_denoised

    def forward(self, params, x_t, t, noise, x0, frame_indices, obs_mask, latent_mask):
        model, diffusion = self._parts
        kwargs = dict(x0=x0, frame_indices=frame_indices, obs_mask=obs_mask,
                      latent_mask=latent_mask)
        common = dict(noise=noise, clip_denoised=self.clip_denoised, model_kwargs=kwargs)
        if self.use_ddim:
            out = diffusion.ddim_sample(_model_fn(model, params), x_t, t, eta=self.eta, **common)
        else:
            out = diffusion.p_sample(_model_fn(model, params), x_t, t, **common)
        return out["sample"]


def _window_specs(B, K, C, H):
    """The window's inputs: name -> (shape, dtype)."""
    return dict(x0=((B, K, C, H, H), torch.float32), frame_indices=((B, K), torch.int64),
                obs_mask=((B, K, 1, 1, 1), torch.float32),
                latent_mask=((B, K, 1, 1, 1), torch.float32))


def export_window_sampler(model, diffusion, params, *, batch_size: int, max_frames: int,
                          in_channels: int, image_size: int, use_ddim: bool = False,
                          eta: float = 0.0, device=None) -> bytes:
    """Serialise the sampler's reverse step for one (B, K, C, H, W) window
    shape on ``device`` (default: the params' device). ``params`` (the
    model's full state dict) stays an ARGUMENT: the artifact holds no
    weights. Returns the artifact's bytes (``torch.export.save``); its
    ``extra_files`` hold the step count, sampler, eta, shape, device and the
    params' names, shapes and dtypes."""
    names = list(model.state_dict())
    if sorted(params) != sorted(names):
        missing, extra = sorted(set(names) - set(params)), sorted(set(params) - set(names))
        raise ValueError(f"params must be the model's state dict: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    device = torch.device(device if device is not None else next(iter(params.values())).device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    params = {k: params[k].detach().to(device) for k in names}
    B, K, C, H = batch_size, max_frames, in_channels, image_size
    specs = _window_specs(B, K, C, H)
    window = {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in specs.items()}
    window["frame_indices"] = torch.arange(K, device=device).repeat(B, 1)
    x = torch.zeros((B, K, C, H, H), device=device)
    t = torch.zeros((B,), dtype=torch.int64, device=device)
    # The schedule tables become graph constants on the export device: put
    # them there before tracing, so the tracer reads real tensors.
    diffusion.tables_on(device)
    step = _Step(model, diffusion, use_ddim, float(eta), True)
    with torch.no_grad(), _eval_mode(model):
        exported = torch.export.export(
            step, (params, x, t, torch.zeros_like(x), *window.values()), strict=False)
    meta = {"shape": [B, K, C, H, H], "num_timesteps": diffusion.num_timesteps,
            "sampler": "ddim" if use_ddim else "ancestral", "eta": float(eta),
            "draws_step_noise": (not use_ddim) or float(eta) != 0.0, "device": str(device),
            "params": [[k, list(v.shape), str(v.dtype).split(".")[-1]] for k, v in params.items()]}
    exported.example_inputs = None  # they hold the weights
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files={META: json.dumps(meta)})
    return buf.getvalue()


def artifact_meta(blob: bytes) -> dict:
    """What an artifact was exported for (its ``extra_files`` entry), read
    without deserialising the program."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        entry = [n for n in z.namelist() if n.endswith("extra/" + META)]
        if len(entry) != 1:
            raise ValueError(f"not a window-sampler artifact: no {META} in it")
        return json.loads(z.read(entry[0]))


def load_window_sampler(blob: bytes):
    """Deserialise an exported sampler; returns the callable
    ``(params, x0, frame_indices, obs_mask, latent_mask, seed, *, noise=None,
    step_noise=None) -> window`` (a ``ServedWindow``), with the artifact's
    metadata (``.meta``) and its ``torch.export`` program (``.program``). A
    call with another window shape, or on another device than the one
    exported for, raises; so does loading a card's artifact where there is
    no card. On the card the step is captured as a CUDA graph at the first
    call and replayed at every step after."""
    meta = artifact_meta(blob)
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the artifact was exported for {device}, and no CUDA device "
                           "is available")
    return ServedWindow(torch.export.load(io.BytesIO(blob)), meta)


class ServedWindow:
    """A loaded artifact's window sampler (the counterpart of the JAX
    module's ``jax.jit(exported.call)``: one compiled program per artifact).

    With ``graphs`` (the default) the loaded step runs on static buffers the
    sampler owns: the state ``x``, the timestep ``t``, the step's noise, the
    window's four inputs and one copy of the parameters. Each call checks
    the caller's ``params`` against the artifact and copies them into that
    copy (``load_params``), so a call with other tensors, or with the same
    tensors changed in place, samples with *those* values; the noise is
    drawn from the call's seed outside the step, in the eager loop's order,
    and copied in. On the card the first step is captured as one
    ``torch.cuda.CUDAGraph`` in a memory pool of its own
    (``ops/_common.py`` ``capture_graph``) and every later step, of this
    window and the next, replays it; ``t`` and the noise are written before
    each replay, and the replay adds the kernels' launch counts its capture
    recorded. A capture that fails raises. On the CPU the same step runs
    eagerly on the same buffers. ``ServedWindow(program, meta,
    graphs=False)`` loops the step eagerly on the caller's tensors: the
    reference the captured window is held to, bitwise. A call returns the
    caller's own tensor, never a buffer.

    The buffers and the parameter copy are shared by every call, so calls
    from several threads take turns: a lock is held from the params' copy
    to the returned clone. A server that wants windows to overlap loads
    one sampler per thread."""

    def __init__(self, program, meta: dict, *, graphs: bool = True):
        self.program, self.meta, self.graphs = program, meta, graphs
        self.step = program.module()
        self.device = torch.device(meta["device"])
        self.shape = tuple(meta["shape"])
        B, K, C, H = self.shape[:4]
        self.specs = _window_specs(B, K, C, H)
        self.param_specs = {k: (tuple(s), getattr(torch, dt)) for k, s, dt in meta["params"]}
        self.what = (f"the artifact was exported for the {meta['sampler']} sampler at "
                     f"{self.shape} on {self.device}")
        self.params = None  # name -> the owned copy, in the artifact's order
        self.buffers = None  # x, t, noise and the window inputs
        self.graph = None
        self.delta = {}  # launch counts one replay adds (ops launch_snapshot keys)
        self.capture_s = None  # seconds of the warm-up and capture
        self.lock = threading.Lock()  # one call at a time on the buffers

    def _checked_params(self, params):
        """The caller's params in the artifact's order, each checked against
        the artifact's name, shape and device."""
        if set(params) != set(self.param_specs):
            names = set(self.param_specs)
            raise KeyError(f"params differ from the exported ones: missing "
                           f"{sorted(names - set(params))[:5]}, unexpected "
                           f"{sorted(set(params) - names)[:5]}")
        ordered = {}
        for k, (shape, _) in self.param_specs.items():
            p = params[k]
            if tuple(p.shape) != shape or p.device != self.device:
                raise ValueError(f"param {k} is {tuple(p.shape)} on {p.device}, exported as "
                                 f"{shape} on {self.device}")
            ordered[k] = p
        return ordered

    def load_params(self, params):
        """Check ``params`` against the artifact and copy them into the
        sampler's own parameter buffers (made at the first call)."""
        ordered = self._checked_params(params)
        with torch.no_grad(), _current(self.device):
            if self.params is None:
                self.params = {k: torch.empty(shape, dtype=dt, device=self.device)
                               for k, (shape, dt) in self.param_specs.items()}
            torch._foreach_copy_(list(self.params.values()), list(ordered.values()))

    def __call__(self, params, x0, frame_indices, obs_mask, latent_mask, seed, *, noise=None,
                 step_noise=None):
        window = dict(x0=x0, frame_indices=frame_indices, obs_mask=obs_mask,
                      latent_mask=latent_mask)
        for name, (want, dt) in self.specs.items():
            got = window[name]
            if tuple(got.shape) != want or got.device != self.device:
                raise ValueError(f"{name} is {tuple(got.shape)} on {got.device}: {self.what}")
            window[name] = got.to(dt)
        if not self.graphs:
            ordered = {k: p.to(self.param_specs[k][1])
                       for k, p in self._checked_params(params).items()}
            return self._eager(ordered, window, seed, noise, step_noise)
        with self.lock:
            self.load_params(params)
            return self._run(window, seed, noise, step_noise)

    def _draws(self, seed, noise, step_noise):
        """The initial noise, then ``step(i)``: step i's noise, or None where
        the sampler takes none; drawn from a generator seeded by ``seed`` in
        step order unless given."""
        device, shape = self.device, self.shape
        gen = torch.Generator(device=device).manual_seed(int(seed))
        x = noise if noise is not None else torch.randn(shape, generator=gen, device=device)

        def step(i):
            if step_noise is not None:
                return step_noise[i]
            if self.meta["draws_step_noise"]:
                return torch.randn(shape, generator=gen, device=device)
            return None

        return x, step

    def _eager(self, params, window, seed, noise, step_noise):
        x, draw = self._draws(seed, noise, step_noise)
        no_noise = torch.zeros(self.shape, device=self.device)
        B = self.shape[0]
        with torch.no_grad():
            for i, s in enumerate(range(self.meta["num_timesteps"] - 1, -1, -1)):
                z = draw(i)
                t = torch.full((B,), s, dtype=torch.int64, device=self.device)
                x = self.step(params, x, t, no_noise if z is None else z, *window.values())
        return x

    def _run(self, window, seed, noise, step_noise):
        with torch.no_grad(), _current(self.device):
            if self.buffers is None:
                self.buffers = dict(
                    x=torch.zeros(self.shape, device=self.device),
                    t=torch.zeros((self.shape[0],), dtype=torch.int64, device=self.device),
                    noise=torch.zeros(self.shape, device=self.device),
                    **{k: torch.empty(shape, dtype=dt, device=self.device)
                       for k, (shape, dt) in self.specs.items()})
            buf = self.buffers
            for name in self.specs:
                buf[name].copy_(window[name])
            x, draw = self._draws(seed, noise, step_noise)
            buf["x"].copy_(x)
            buf["noise"].zero_()
            for i, s in enumerate(range(self.meta["num_timesteps"] - 1, -1, -1)):
                buf["t"].fill_(s)
                z = draw(i)
                if z is not None:
                    buf["noise"].copy_(z)
                if self.graph is not None:
                    self.graph.replay()
                    add_launches(self.delta)
                elif self.device.type == "cuda":
                    t0 = time.perf_counter()
                    with tracing.span("graph.capture"):
                        self.graph, _, _, self.delta = capture_graph(self._step, self.device)
                    self.capture_s = time.perf_counter() - t0
                    tracing.count("graph.captures")
                else:
                    self._step()
            return buf["x"].clone()

    def _step(self):
        """One reverse step on the buffers: reads them, writes ``x``."""
        buf = self.buffers
        out = self.step(self.params, buf["x"], buf["t"], buf["noise"],
                        *(buf[name] for name in self.specs))
        buf["x"].copy_(out)


def _flatten(tree, prefix=()):
    if not isinstance(tree, Mapping):
        yield prefix, tree
        return
    if not tree:
        raise ValueError(f"save_params_npz cannot store the empty dict at {'/'.join(prefix)!r}")
    for key, value in tree.items():
        if not isinstance(key, str) or "/" in key or key == BF16_KEYS:
            raise ValueError(f"save_params_npz needs nested str-keyed dicts with '/'-free "
                             f"keys; got path entry {key!r}")
        yield from _flatten(value, prefix + (key,))


def save_params_npz(params, path: str):
    """Write a params tree (nested str-keyed dicts of tensors, e.g. a state
    dict) to an .npz keyed by '/'-joined paths. numpy has no bfloat16: a
    bf16 leaf is stored bit for bit as uint16, and its key is listed in the
    file, so that ``load_params_npz`` restores it as bf16. Keys the inverse
    could not rebuild raise."""
    flat, bf16 = {}, []
    for path_keys, leaf in _flatten(params):
        key = "/".join(path_keys)
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            t = t.view(torch.int16)
            flat[key] = t.numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    np.savez(path, **flat, **{BF16_KEYS: np.asarray(bf16, dtype=str)})


def load_params_npz(path: str, like=None, device="cpu"):
    """Inverse of ``save_params_npz``. Without a template the nested-dict
    tree is rebuilt from the '/'-joined keys (a serving process needs no
    model code); tensors go to ``device``. With a template ``like``, its
    keys are read and each leaf takes the template's dtype and device."""
    with np.load(path) as data:
        bf16 = set(data[BF16_KEYS].tolist()) if BF16_KEYS in data.files else set()

        def leaf(key):
            a = data[key]
            if key in bf16:
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(a)

        if like is None:
            tree: dict = {}
            for key in data.files:
                if key == BF16_KEYS:
                    continue
                *parents, last = key.split("/")
                node = tree
                for p in parents:
                    node = node.setdefault(p, {})
                node[last] = leaf(key).to(device)
            return tree
        return _restore_like(like, (), leaf)


def _restore_like(like, prefix, leaf):
    if isinstance(like, Mapping):
        return {k: _restore_like(v, prefix + (k,), leaf) for k, v in like.items()}
    return leaf("/".join(prefix)).to(dtype=like.dtype, device=like.device)
