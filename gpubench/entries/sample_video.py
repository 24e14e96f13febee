"""Entry ``sample_video``: long videos through the port's
``VideoSampler.sample_video``, window by window under a sampling scheme,
on its default captured path (one CUDA graph of a reverse step per window
shape), decoded once per video where the configuration has a VAE.

Traffic keys: ``batch_size``, ``max_frames`` (K), ``scheme``,
``video_length`` (T), ``n_obs``, ``step_size``, ``respacing`` (a DDIM
spacing, "ddimN"), ``compare_windows`` (windows the reference samples
again), ``compare_frames`` (decoded frames it decodes again),
``reference_rows`` (rows per reference call), ``warmup_seconds`` (load
before the window), ``trace_units``.

The unit of work is a window without a VAE (its generated frames finish
when it returns) and a video with one (its frames finish when the decode
returns). The window ends at the first unit that finishes after
``--seconds``: the benchmark's wrapper of ``sample_window`` stops the video
there. The wrapper draws each window's initial noise from the run's seed
and passes it in (``noise=``), and keeps the window's inputs and output for
the check. A latent video's observed frames and the latent statistics are
drawn from the seed too.

The check, after the window: every window's frame indices against the
scheme's (a frozen copy in ``reference/schemes.py``), every window's
observed frames against the frames the earlier windows produced (the
driver's gather and scatter, exactly), a sample of windows drawn from the
seed against the reference's DDIM window from the same inputs and noise
(plain f32 U-Net), and a sample of decoded frames against the reference
decoder on the latents the windows produced.
"""

from __future__ import annotations

import time


import numpy as np
import torch

from common import full_f32, rel_l2, sub_seed, sync
from program import (build_codec, build_diffusion, build_unet, build_vae, unet_weights,
                     vae_decoder_weights)
from reference.diffusion import Diffusion
from reference.schemes import sampling_schemes as reference_schemes
from reference.unet import UNet
from reference.vae import TemporalDecoder

W_WEIGHTS, W_VAE, W_STATS, W_NOISE, W_PICK, W_VIDEO = 1, 2, 3, 4, 5, 100


class _Closed(Exception):
    """The window's time is up: ends the video being sampled."""


def latent_stats(config, seed):
    rng = np.random.default_rng(sub_seed(seed, W_STATS))
    C = config["in_channels"]
    return {"mean": rng.normal(0, 0.3, C).astype(np.float32),
            "std": rng.uniform(0.5, 1.5, C).astype(np.float32)}


def make_video(config, traffic, seed, index):
    """Video ``index`` of the run: its first ``n_obs`` frames drawn from the
    seed (uniform in [-1, 1]), the rest to be generated."""
    B, T, n = traffic["batch_size"], traffic["video_length"], traffic["n_obs"]
    C, S = config["in_channels"], config["image_size"]
    video = np.zeros((B, T, C, S, S), np.float32)
    rng = np.random.default_rng(sub_seed(seed, W_VIDEO + index))
    video[:, :n] = rng.uniform(-1, 1, (B, n, C, S, S)).astype(np.float32)
    return video


def run(run):
    from lfvdm_tpu_torch.sampling.driver import VideoSampler

    cfg, tr, dev, seed = run.cell["config"], run.cell["traffic"], run.device, run.seed
    B = tr["batch_size"]
    weights = unet_weights(cfg, sub_seed(seed, W_WEIGHTS), dev)
    model = build_unet(cfg, weights, dev)
    codec, decoder, stats = None, None, None
    if cfg.get("vae"):
        decoder = vae_decoder_weights(cfg, sub_seed(seed, W_VAE), dev)
        stats = latent_stats(cfg, seed)
        codec = build_codec(cfg, build_vae(cfg, decoder, sub_seed(seed, W_VAE), dev), stats)
    sampler = VideoSampler(model, build_diffusion(cfg, tr["respacing"]), use_ddim=True,
                           eta=0.0, codec=codec)
    scheme = dict(scheme_name=tr["scheme"], n_obs=tr["n_obs"], max_frames=tr["max_frames"],
                  step_size=tr["step_size"])
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, W_NOISE))
    windows, decoded = [], {}
    state = {"measuring": False, "video": 0}
    unit_is_window = codec is None
    sample_window = sampler.sample_window

    def window(x0, frame_indices, obs_mask, latent_mask, *, generator=None, noise=None,
               step_noise=None):
        noise = torch.randn(tuple(np.shape(x0)), generator=gen, device=dev)
        with run.span("window"):
            out = sample_window(x0, frame_indices, obs_mask, latent_mask, noise=noise)
            sync(dev)
        if state["measuring"]:
            n_latent = int(np.asarray(latent_mask)[0].sum())
            windows.append(dict(video=state["video"], x0=x0, fi=np.asarray(frame_indices),
                                n_obs=int(np.asarray(obs_mask)[0].sum()), noise=noise, out=out))
            if unit_is_window:
                run.finish_unit(len(x0) * n_latent)
                if run.remaining() <= 0:
                    raise _Closed
        return out

    sampler.sample_window = window
    if codec is not None:
        decode = codec.decode

        def timed_decode(video):
            with run.span("decode"):
                out = decode(video)
                sync(dev)
            if state["measuring"]:
                decoded[state["video"]] = out
                run.finish_unit(len(out) * (tr["video_length"] - tr["n_obs"]))
            return out

        codec.decode = timed_decode

    # Set-up: one window of each shape the scheme yields, and one decode;
    # then whole videos until the card has run ``warmup_seconds`` (a card
    # that was idle runs its first seconds of load slower).
    t_warm = time.perf_counter()
    _, used = sampler.sample_video(make_video(cfg, tr, seed, 0), generator=gen,
                                   just_get_indices=True, **scheme)
    C, S = cfg["in_channels"], cfg["image_size"]
    shapes = {}
    for obs, lat in used:
        shapes.setdefault((len(obs[0]), len(lat[0])), (obs, lat))
    for (n_obs, n_lat), (obs, lat) in shapes.items():
        fi = np.asarray([list(o) + list(l) for o, l in zip(obs, lat)], np.int64)
        K = n_obs + n_lat
        masks = np.zeros((B, K, 1, 1, 1), np.float32)
        masks[:, :n_obs] = 1
        window(np.zeros((B, K, C, S, S), np.float32), fi, masks, 1 - masks)
    if codec is not None:
        codec.decode(torch.zeros((B, tr["video_length"], C, S, S), device=dev))
    while time.perf_counter() - t_warm < tr["warmup_seconds"]:
        sampler.sample_video(make_video(cfg, tr, seed, 0), generator=gen, **scheme)
    sync(dev)

    run.start_window()
    state["measuring"] = True
    try:
        while True:
            video = make_video(cfg, tr, seed, state["video"])
            with run.span("video"):
                sampler.sample_video(video, generator=gen, **scheme)
            state["video"] += 1
            if run.remaining() <= 0:
                break
    except _Closed:
        pass
    run.close_window()
    run.counts["steps_per_window"] = sampler.diffusion.num_timesteps
    run.counts["frames_per_decode"] = B * tr["video_length"]
    run.attempted = len(run.units)
    bad = [i if unit_is_window else w["video"] for i, w in enumerate(windows)
           if not bool(torch.isfinite(w["out"]).all())]
    bad += [v for v, out in decoded.items() if not bool(torch.isfinite(out).all())]
    run.failed = len(set(bad))
    run.work.update(model_work(cfg, tr, windows, decoded, sampler.diffusion.num_timesteps,
                               unit_is_window))
    return dict(weights=weights, decoder=decoder, stats=stats, windows=windows,
                decoded=decoded, unit_is_window=unit_is_window)


def model_work(cfg, tr, windows, decoded, steps, unit_is_window):
    """Model FLOPs of each unit the window finished (its windows' model
    calls, and its decode), and the least seconds of the port kernels'
    launches in the traced units' windows."""
    from work import decoder_flops, unet_forward

    unit_flops = [0.0] * (len(windows) if unit_is_window else len(decoded))
    least = 0.0
    traced = tr["trace_units"]
    for i, w in enumerate(windows):
        unit = i if unit_is_window else w["video"]
        call = unet_forward(cfg, *w["fi"].shape)
        unit_flops[unit] += call["flops"] * steps
        if unit < traced:
            least += sum(call["kernels"].values()) * steps
    for v, out in decoded.items():
        unit_flops[v] += decoder_flops(cfg) * out.shape[0] * out.shape[1]
    return {"unit_flops": unit_flops, "kernel_least_s": least}


def check(run, kept, control: bool = False):
    """Fill ``run.checks``; with ``control`` also ``run.control``: the same
    numbers for the reference in the program's place in float8 (the U-Net)
    and bfloat16 (the decoder)."""
    cfg, tr, dev, seed = run.cell["config"], run.cell["traffic"], run.device, run.seed
    limits = tr["limits"]
    windows, B = kept["windows"], tr["batch_size"]
    videos = sorted({w["video"] for w in windows})

    index_mismatch = gather_mismatch = 0
    latents = {}
    for v in videos:
        mine = [w for w in windows if w["video"] == v]
        plan = reference_schemes[tr["scheme"]](video_length=tr["video_length"],
                                               num_obs=tr["n_obs"], max_frames=tr["max_frames"],
                                               step_size=tr["step_size"])
        plan.set_videos(np.zeros(B))
        plan = list(plan)
        if len(mine) != len(plan) and (v != videos[-1] or not kept["unit_is_window"]):
            index_mismatch += abs(len(plan) - len(mine))  # a video that ended short or long
        buf = torch.as_tensor(make_video(cfg, tr, seed, v), device=dev)
        for w, (obs, lat) in zip(mine, plan):
            want = np.asarray([[int(i) for i in o] + [int(i) for i in lt] for o, lt in zip(obs, lat)])
            fi, n = w["fi"], w["n_obs"]
            if want.shape != fi.shape or not np.array_equal(want, fi) or n != len(obs[0]):
                index_mismatch += 1
                continue
            x0 = torch.as_tensor(w["x0"], device=dev)
            rows = torch.arange(B, device=dev)[:, None]
            idx = torch.as_tensor(fi, device=dev)
            gather_mismatch += int((buf[rows, idx] != x0).sum())
            buf[rows, idx[:, n:]] = w["out"][:, n:].float()
        latents[v] = buf
    run.checks["index_mismatch"] = (index_mismatch, limits["index_mismatch"])
    run.checks["gather_mismatch"] = (gather_mismatch, limits["gather_mismatch"])

    rng = np.random.default_rng(sub_seed(seed, W_PICK))
    picks = rng.choice(len(windows), size=min(tr["compare_windows"], len(windows)), replace=False)
    ref = UNet(cfg).to(dev)
    ref.load_state_dict(kept["weights"])
    diff = Diffusion(cfg, tr["respacing"], device=dev)
    gaps, control_gaps = [], []
    with torch.no_grad(), full_f32():
        for i in sorted(picks):
            w = windows[i]
            n = w["n_obs"]
            want = _ddim_rows(ref.set_precision("float32"), diff, w, tr["reference_rows"], dev)
            gaps.append(rel_l2(w["out"][:, n:], want[:, n:]))
            if control:
                low = _ddim_rows(ref.set_precision("fp8"), diff, w, tr["reference_rows"], dev)
                control_gaps.append(rel_l2(low[:, n:], want[:, n:]))
    run.checks["window_rel_l2"] = (max(gaps) if gaps else float("inf"), limits["window_rel_l2"])
    run.control = {"window_rel_l2": max(control_gaps)} if control else None
    del ref

    if kept["decoded"]:
        v = max(kept["decoded"])
        got = kept["decoded"][v]
        mean = torch.as_tensor(kept["stats"]["mean"], device=dev).reshape(1, 1, -1, 1, 1)
        std = torch.as_tensor(kept["stats"]["std"], device=dev).reshape(1, 1, -1, 1, 1)
        z = latents[v] * std + mean
        vae = cfg["vae"]
        dec = TemporalDecoder(vae["block_out_channels"], vae["layers_per_block"],
                              vae["latent_channels"]).to(dev)
        dec.load_state_dict({k[len("decoder."):]: t for k, t in kept["decoder"].items()})
        flat = rng.choice(z.shape[0] * z.shape[1], size=tr["compare_frames"], replace=False)
        b, t = np.divmod(np.sort(flat), z.shape[1])
        with torch.no_grad(), full_f32():
            want = torch.cat([dec(z[b[i:i + 8], t[i:i + 8]]) for i in range(0, len(b), 8)])
            run.checks["decode_rel_l2"] = (rel_l2(got[b, t], want), limits["decode_rel_l2"])
            if control:
                with torch.autocast("cuda" if dev != "cpu" else "cpu", dtype=torch.bfloat16):
                    low = torch.cat([dec(z[b[i:i + 8], t[i:i + 8]]).float()
                                     for i in range(0, len(b), 8)])
                run.control["decode_rel_l2"] = rel_l2(low, want)


def _ddim_rows(model, diff, w, rows, dev):
    """The reference's DDIM window for the recorded window ``w``, in blocks
    of ``rows`` rows."""
    x0 = torch.as_tensor(w["x0"], device=dev)
    fi = torch.as_tensor(w["fi"], device=dev)
    B, K = fi.shape
    obs = torch.zeros((B, K, 1, 1, 1), device=dev)
    obs[:, :w["n_obs"]] = 1
    outs = []
    for r in range(0, B, rows):
        part = slice(r, r + rows)
        kw = dict(x0=x0[part], frame_indices=fi[part], obs_mask=obs[part],
                  latent_mask=1 - obs[part])
        outs.append(diff.ddim(model, w["noise"][part], kw))
    return torch.cat(outs)
