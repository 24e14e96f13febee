"""The port's CLIs accept every flag of the repo's JAX scripts, with the
same default, and add only ``--device``; their ``--help`` runs in a fresh
interpreter where JAX, flax, orbax and the JAX package cannot be imported.
The JAX ``video_optimal_schedule.py``, ``carla_regressor_train.py``, the
two export scripts and the three weight converters build their parsers
inside ``main()``: those are caught at ``parse_args``. The converters'
source libraries are blocked too. ``export_sampler``'s ``--device`` takes the place of the
JAX script's ``--platform``; ``export_params`` selects no device and adds
nothing.
"""

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

from lfvdm_tpu_torch.scripts import (
    carla_regressor_train,
    convert_i3d,
    convert_lpips,
    convert_svd_vae,
    export_params,
    export_sampler,
    video_fvd,
    video_make_mp4,
    video_optimal_schedule,
    video_sample,
    video_to_world_coords,
    video_train,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = {"video_sample": video_sample, "video_train": video_train,
        "video_optimal_schedule": video_optimal_schedule, "video_fvd": video_fvd,
        "video_to_world_coords": video_to_world_coords, "video_make_mp4": video_make_mp4,
        "carla_regressor_train": carla_regressor_train, "export_sampler": export_sampler,
        "export_params": export_params, "convert_svd_vae": convert_svd_vae,
        "convert_lpips": convert_lpips, "convert_i3d": convert_i3d}
# Flags of a JAX script that the port's names otherwise, and flags the port adds.
RENAMED = {"export_sampler": {"--platform": "--device"}}
ADDED = {"export_sampler": set(), "export_params": set()}


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(name):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        module = importlib.import_module(name)
    finally:
        sys.path.pop(0)
    if hasattr(module, "create_argparser"):
        return module.create_argparser()

    def caught(parser, *args, **kwargs):
        raise _Parsed(parser)

    saved = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = caught
    try:
        module.main()
    except _Parsed as e:
        return e.parser
    finally:
        argparse.ArgumentParser.parse_args = saved
    raise AssertionError(f"{name}.main() built no parser")


def _options(parser):
    """{option string: action} of a parser's flags (``-h`` left out), and
    its positional arguments."""
    flags = {opt: a for a in parser._actions for opt in a.option_strings
             if opt not in ("-h", "--help")}
    positional = [a.dest for a in parser._actions if not a.option_strings]
    return flags, positional


@pytest.mark.parametrize("name", list(PORT))
def test_every_jax_flag_with_its_default(name):
    jflags, jpos = _options(_jax_parser(name))
    tflags, tpos = _options(PORT[name].create_argparser())
    renamed = RENAMED.get(name, {})
    assert tpos == jpos
    assert set(tflags) - set(jflags) == ADDED.get(name, {"--device"}) | set(renamed.values())
    assert not set(jflags) - set(tflags) - set(renamed)
    for opt, ja in jflags.items():
        if opt in renamed:
            continue
        ta = tflags[opt]
        assert ta.default == ja.default, opt
        assert ta.required == ja.required, opt
        assert (sorted(ta.choices) if ta.choices else None) == \
            (sorted(ja.choices) if ja.choices else None), opt
        assert getattr(ta.type, "__name__", None) == getattr(ja.type, "__name__", None), opt
        assert ta.nargs == ja.nargs and ta.const == ja.const, opt
    if "--device" in tflags:
        assert tflags["--device"].default == "cuda"


@pytest.mark.parametrize("name", list(PORT))
def test_same_values_parsed(name):
    """Each flag of a typical command line parses to the same value."""
    argv = {"video_sample": ["ckpt.pt", "--sampling_scheme", "hierarchy-2", "--T", "300",
                             "--use_ddim", "yes", "--timestep_respacing", "ddim50",
                             "--max_frames", "20", "--just_visualise"],
            "video_train": ["--dataset", "carla_no_traffic", "--T", "100", "--batch_size", "2",
                            "--resume", "t", "--attention_resolutions", "16,8",
                            "--learn_sigma", "False", "--lr", "3e-4"],
            "video_optimal_schedule": ["--eval_dir", "ev", "--sampling_scheme", "hierarchy-2",
                                       "--optimality", "lpips", "--T", "300",
                                       "--max_frames", "20", "--num_videos", "4"],
            "video_fvd": ["--eval_dir", "ev", "--num_videos", "16", "--T", "300",
                          "--real_dir", "reals", "--temporal_stride", "2", "--batch_size", "8"],
            "video_to_world_coords": ["--eval_dir", "ev", "--classifier_path", "c.pt",
                                      "--regressor_path", "r.pt", "--batch_size", "32"],
            "video_make_mp4": ["--eval_dir", "ev", "--add_gt", "no", "--do_n", "3",
                               "--n_seeds", "2", "--obs_length", "36", "--format", "mp4"],
            "carla_regressor_train": ["--data_dir", "d", "--is_classifier", "True",
                                      "--lr", "0.01", "--num_epochs", "3"],
            "export_sampler": ["--random_init", "True", "--out", "o", "--batch_size", "2",
                               "--use_ddim", "yes", "--eta", "0.5", "--image_size", "32",
                               "--timestep_respacing", "ddim25", "--ema_rate", "raw"],
            "export_params": ["run", "--step", "3", "--ema_rate", "raw"],
            "convert_svd_vae": ["--out", "w/vae"], "convert_lpips": ["--out", "w/l.npz"],
            "convert_i3d": ["--out", "w/i3d.npz"]}[name]
    want = vars(_jax_parser(name).parse_args(argv))
    got = vars(PORT[name].create_argparser().parse_args(argv))
    for jax_dest, dest in RENAMED.get(name, {}).items():
        want.pop(jax_dest.lstrip("-"))
        assert got.pop(dest.lstrip("-")) == "cuda"
    if name not in ADDED:
        assert got.pop("device") == "cuda"
    assert got == want


HELP = """
import importlib.abc, runpy, sys
BLOCKED = ("jax", "flax", "optax", "orbax", "lfvdm_tpu", "scripts", "diffusers", "lpips",
           "tensorflow", "tensorflow_hub")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.argv = ["{name}", "--help"]
runpy.run_module("lfvdm_tpu_torch.scripts.{name}", run_name="__main__")
"""


@pytest.mark.parametrize("name", list(PORT))
def test_help_runs_with_jax_blocked(name):
    run = subprocess.run([sys.executable, "-c", HELP.format(name=name)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "usage:" in run.stdout
    assert ("--device" in run.stdout) == (name != "export_params")
