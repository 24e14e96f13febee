"""Results directory layout helpers (a copy of lfvdm_tpu/utils/paths.py).

``results/<ckpt subpath>/<ckpt name>[_ddim][_dpm][_respaceN]/<scheme>_{K}_{step}_{T}_{n_obs}/``,
the reference's layout, so sample, FVD and coordinate runs are idempotent
and addressable by config, and both packages write the same paths.
"""

from __future__ import annotations

from pathlib import Path


def get_model_results_path(
    checkpoint_path: str,
    *,
    use_ddim: bool = False,
    use_dpm: bool = False,
    timestep_respacing: str = "",
    eval_dir: str | None = None,
    checkpoint_step: int | None = None,
) -> Path:
    if eval_dir:
        return Path(eval_dir)
    postfix = ""
    if use_ddim:
        postfix += "_ddim"
    if use_dpm:
        postfix += "_dpm"
    if timestep_respacing:
        postfix += f"_respace{timestep_respacing}"
    ckpt = Path(checkpoint_path)
    name = ckpt.stem
    if name.endswith("latest") and checkpoint_step is not None:
        name += f"_{checkpoint_step}"
    name += postfix
    subpath = None
    for idx, part in enumerate(ckpt.parts):
        if "checkpoint" in part:
            subpath = Path(*ckpt.parts[idx + 1:])
            break
    if subpath is None:
        subpath = Path(ckpt.name)
    return Path("results") / subpath.parent / name


def get_eval_run_identifier(
    sampling_scheme: str,
    max_frames: int,
    max_latent_frames: int,
    T: int,
    n_obs: int,
    *,
    optimality: str | None = None,
    dataset_partition: str = "test",
) -> str:
    res = sampling_scheme
    if optimality is not None:
        res += f"_optimal-{optimality}"
    res += f"_{max_frames}_{max_latent_frames}_{T}_{n_obs}"
    if dataset_partition == "train":
        res = "trainset_" + res
    return res
