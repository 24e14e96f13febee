"""The port's CLIs (``lfvdm_tpu_torch.scripts.video_sample`` / ``video_train``)
and the modules they need, against the JAX package and its scripts, on the
CPU (``--device cpu``).

Sampling noise does not cross between the packages, so the deterministic
parts are held against JAX: the reference ``.pt`` loading (the U-Net forward
from both packages' loaders, f32, relative L2 <= 1e-5), the results paths,
the ``model_config.json``, the ``--just_visualise`` PNG (bytes equal), the
``--init_from_pt`` adoption and its errors (equal), the vis masks (equal).
The port's own runs are checked for what must hold: uint8 files of the
layout's names and shapes, observed frames kept exactly, a second run that
writes nothing, a training run directory that sampling reads back.
"""

import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.utils import paths as jpaths
from lfvdm_tpu.utils.torch_convert import convert_reference_checkpoint
from lfvdm_tpu_torch.config import create_model_and_diffusion as t_create
from lfvdm_tpu_torch.data.datasets import get_test_dataset
from lfvdm_tpu_torch.scripts import video_sample, video_train
from lfvdm_tpu_torch.utils import paths as tpaths
from lfvdm_tpu_torch.utils.convert import load_reference_checkpoint

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"

# A tiny pixel config at the synthetic dataset's 64 px.
CFG64 = dict(image_size=64, in_channels=3, num_channels=32, num_res_blocks=1,
             attention_resolutions="8", diffusion_steps=8, noise_schedule="cosine",
             compute_dtype="float32")
SAMPLE_ARGS = ["--sampling_scheme", "autoreg", "--T", "6", "--n_obs", "2", "--max_frames", "4",
               "--batch_size", "2", "--use_ddim", "True", "--timestep_respacing", "ddim2",
               "--device", "cpu"]
TRAIN_ARGS = ["--dataset", "synthetic", "--T", "6", "--num_channels", "32",
              "--num_res_blocks", "1", "--attention_resolutions", "8", "--diffusion_steps", "8",
              "--noise_schedule", "cosine", "--compute_dtype", "float32", "--batch_size", "2",
              "--max_frames", "4", "--device", "cpu"]


def _jax_script(name):
    sys.path.insert(0, str(SCRIPTS))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def write_reference_pt(path, cfg, seed=0, **extra_config):
    """A reference-format checkpoint of the port's U-Net at ``cfg``, every
    parameter perturbed (the zero-initialised layers carry signal)."""
    model, _ = t_create(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    torch.save({"state_dict": model.state_dict(), "config": dict(cfg, **extra_config)}, path)
    return model


@pytest.fixture(scope="module")
def pt64(tmp_path_factory):
    path = tmp_path_factory.mktemp("checkpoints") / "model_000200.pt"
    write_reference_pt(path, CFG64, dataset="synthetic", max_frames=4)
    return str(path)


@pytest.fixture
def quiet_loggers(monkeypatch):
    """Both packages' loggers are module globals: a run's JSONL sink is
    undone after the test."""
    from lfvdm_tpu.utils.logger import logger as jlogger
    from lfvdm_tpu_torch.utils.logger import logger as tlogger

    for lg in (jlogger, tlogger):
        monkeypatch.setattr(lg, "_jsonl_path", lg._jsonl_path)


# ---- reference .pt loading ----


def test_load_reference_checkpoint_matches_jax_forward(tmp_path):
    """The tiny flagship config, f32: the port's model from
    ``load_reference_checkpoint`` and the JAX model from
    ``convert_reference_checkpoint`` give the same forward (relative L2
    <= 1e-5) on a window with observed, latent and padding frames."""
    from test_torch_unet import CFG, make_inputs, run_port

    path = tmp_path / "ema_0.9999_000100.pt"
    write_reference_pt(path, CFG)
    model, diffusion, config = load_reference_checkpoint(str(path), device="cpu")
    assert config == CFG and diffusion.num_timesteps == CFG["diffusion_steps"]
    assert next(model.parameters()).device.type == "cpu"
    params, jconfig = convert_reference_checkpoint(str(path))
    assert jconfig == config
    jmodel, _ = j_create(jconfig)
    x, t, kw = make_inputs()
    got, _ = run_port(model.eval(), x, t, kw)
    want, _ = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel


def test_load_reference_checkpoint_reads_the_config_defaults(tmp_path):
    """No image_size, num_res_blocks or attention_resolutions in the config:
    64 px, 2 res blocks, "16,8", as the JAX converter reads them; the
    weights must fit (strict), and an unlisted image size raises in both."""
    cfg = dict(in_channels=3, num_channels=32, compute_dtype="float32")
    path = tmp_path / "m.pt"
    write_reference_pt(path, cfg)
    model, _, config = load_reference_checkpoint(str(path), device="cpu")
    assert config == cfg and len(model.output_blocks) == 4 * 3
    convert_reference_checkpoint(str(path))  # the JAX converter reads the same tree
    bad = torch.load(path, weights_only=False)
    bad["state_dict"].pop("out.2.bias")
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="out.2.bias"):
        load_reference_checkpoint(str(tmp_path / "bad.pt"), device="cpu")
    bad = torch.load(path, weights_only=False)
    bad["config"]["image_size"] = 48
    torch.save(bad, tmp_path / "size.pt")
    with pytest.raises(ValueError, match="image size"):
        load_reference_checkpoint(str(tmp_path / "size.pt"), device="cpu")
    with pytest.raises(KeyError):
        convert_reference_checkpoint(str(tmp_path / "size.pt"))


# ---- results layout ----


@pytest.mark.parametrize("ckpt", ["checkpoints/abc123/ema_0.9999_550000.pt",
                                  "/data/checkpoint_dir/run/model_latest.pt",
                                  "runs/xyz/latest.pt", "plain.pt", "checkpoints/run7"])
@pytest.mark.parametrize("ddim,dpm,respacing", [(False, False, ""), (True, False, "ddim25"),
                                                 (False, True, "dpm20")])
@pytest.mark.parametrize("eval_dir,step", [(None, None), (None, 1200), ("ev/x", None)])
def test_paths_equal_jax(ckpt, ddim, dpm, respacing, eval_dir, step):
    kw = dict(use_ddim=ddim, use_dpm=dpm, timestep_respacing=respacing, eval_dir=eval_dir,
              checkpoint_step=step)
    assert tpaths.get_model_results_path(ckpt, **kw) == jpaths.get_model_results_path(ckpt, **kw)
    for opt, part in ((None, "test"), ("lpips", "test"), ("index", "train")):
        args = ("hierarchy-2", 20, 10, 300, 36)
        kw2 = dict(optimality=opt, dataset_partition=part)
        assert (tpaths.get_eval_run_identifier(*args, **kw2)
                == jpaths.get_eval_run_identifier(*args, **kw2))


# ---- video_sample ----


def test_video_sample_writes_the_jax_layout_and_is_idempotent(pt64, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = video_sample.main([pt64] + SAMPLE_ARGS)
    eval_dir = (jpaths.get_model_results_path(pt64, use_ddim=True, timestep_respacing="ddim2")
                / jpaths.get_eval_run_identifier("autoreg", 4, 2, 6, 2))
    assert run["eval_dir"] == eval_dir and eval_dir.parts[0] == "results"
    names = sorted(p.name for p in (eval_dir / "samples").iterdir())
    assert names == ["sample_0000-0.npy", "sample_0001-0.npy"]
    assert run["written"] == [eval_dir / "samples" / n for n in names]
    assert run["model_calls"] == 2 * 2  # two windows of DDIM-2
    dataset = get_test_dataset("synthetic", T=6)
    for i, name in enumerate(names):
        video = np.load(eval_dir / "samples" / name)
        assert video.dtype == np.uint8 and video.shape == (6, 3, 64, 64)
        np.testing.assert_array_equal(video[:2], video_sample.to_uint8(dataset[i][:2]))
    # model_config.json: what the JAX script writes for the same checkpoint
    _, jconfig = convert_reference_checkpoint(pt64)
    jconfig.update(use_ddim=True, timestep_respacing="ddim2")
    assert json.loads((eval_dir / "model_config.json").read_text()) == json.loads(
        json.dumps({k: v for k, v in jconfig.items()
                    if isinstance(v, (str, int, float, bool, list, type(None)))}))
    # A second run finds every file and writes nothing.
    stamps = {n: (eval_dir / "samples" / n).stat().st_mtime_ns for n in names}
    again = video_sample.main([pt64] + SAMPLE_ARGS)
    assert again["written"] == [] and again["model_calls"] == 0
    assert stamps == {n: (eval_dir / "samples" / n).stat().st_mtime_ns for n in names}


def test_just_visualise_png_equals_jax_script(pt64, tmp_path, monkeypatch):
    argv = [pt64, "--sampling_scheme", "hierarchy-2", "--T", "20", "--n_obs", "2",
            "--max_frames", "6", "--batch_size", "2", "--just_visualise"]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "t")
    video_sample.main(argv + ["--device", "cpu"])
    monkeypatch.chdir(tmp_path / "j")
    monkeypatch.setenv("LFVDM_COMPILE_CACHE", "")
    monkeypatch.setattr(sys, "argv", ["video_sample.py"] + argv)
    _jax_script("video_sample").main()
    got = sorted((tmp_path / "t" / "visualisations").iterdir())
    want = sorted((tmp_path / "j" / "visualisations").iterdir())
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 2
    for a, b in zip(got, want):
        assert a.read_bytes() == b.read_bytes()


def test_unported_sources_and_flags_raise_naming_the_roadmap(pt64, tmp_path):
    """The JAX orbax run directory names A8; ``--dp_devices 2`` on the CPU
    (one device) and ``--fsdp 2`` in one process raise the JAX package's
    refusals."""
    with pytest.raises(ValueError, match=r"^--dp_devices 2 > 1 visible devices$"):
        video_sample.main([pt64] + SAMPLE_ARGS + ["--dp_devices", "2"])
    (tmp_path / "params.msgpack").write_bytes(b"")  # read now: an empty file is unreadable
    with pytest.raises(ValueError, match="truncated msgpack"):
        video_sample.main([str(tmp_path / "params.msgpack")] + SAMPLE_ARGS)
    (tmp_path / "orbax" / "100" / "default").mkdir(parents=True)  # a JAX run's step
    with pytest.raises(SystemExit, match="A8.*export_params.py.*msgpack"):
        video_sample.main([str(tmp_path / "orbax")] + SAMPLE_ARGS)
    with pytest.raises(ValueError, match=r"^1 devices not divisible by fsdp=2$"):
        video_train.main(TRAIN_ARGS + ["--fsdp", "2", "--checkpoint_dir", str(tmp_path / "run")])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_default_to_the_card(pt64):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        video_sample.main([pt64] + SAMPLE_ARGS[:-2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        video_train.main(TRAIN_ARGS[:-2])


# ---- video_train ----


def test_video_train_run_dir_samples_with_raw_weights(tmp_path, monkeypatch, quiet_loggers):
    """Two steps on the CPU write a run directory (config, raw parameters,
    EMA, train state, metrics); video_sample reads its raw weights back."""
    monkeypatch.chdir(tmp_path)
    loop = video_train.main(TRAIN_ARGS + ["--max_steps", "2", "--save_interval", "2",
                                          "--sample_interval", "0", "--log_interval", "1"])
    run = Path(loop.checkpoint_dir)
    assert run.parent.name == "checkpoints" and len(run.name) == 8  # keyed by the run id
    config = json.loads((run / "config.json").read_text())
    assert config["image_size"] == 64 and config["T"] == 6 and config["dataset"] == "synthetic"
    assert "device" not in config and "fused_skip_conv" not in config
    assert sorted(d.name for d in run.iterdir() if d.is_dir()) == ["0", "2"]
    assert sorted(f.name for f in (run / "2").iterdir()) == ["ema_0.9999.pt", "params.pt",
                                                             "train_state.pt"]
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 2

    out = video_sample.main([str(run), "--ema_rate", "raw", "--eval_dir", "ev"] + SAMPLE_ARGS)
    assert [p.name for p in out["written"]] == ["sample_0000-0.npy", "sample_0001-0.npy"]
    model, _, _ = video_sample.load_model_from_checkpoint(str(run), True, "ddim2",
                                                          ema_rate="raw", device="cpu")
    for name, p in model.named_parameters():
        torch.testing.assert_close(p, loop.model.state_dict()[name], rtol=0, atol=0)
    ema_model, _, _ = video_sample.load_model_from_checkpoint(str(run), True, "", device="cpu")
    torch.testing.assert_close(dict(ema_model.named_parameters())["out.2.weight"],
                               loop.state.ema["0.9999"]["out.2.weight"], rtol=0, atol=0)


class _CaptureLoop:
    """TrainLoop stand-in: records its keyword arguments, runs nothing."""

    captured = None

    def __init__(self, **kwargs):
        _CaptureLoop.captured = kwargs

    def run_loop(self, max_steps=None):
        pass


def _both_mains(monkeypatch, argv):
    """The JAX script's main and the port's on ``argv``: their captured
    TrainLoop kwargs, or the error each raised."""
    out = []
    for which in ("jax", "port"):
        if which == "jax":
            mod = _jax_script("video_train")
            monkeypatch.setattr(sys, "argv", ["video_train.py"] + argv)
            call = mod.main
        else:
            mod = video_train
            call = lambda: mod.main(argv + ["--device", "cpu"])  # noqa: E731
        monkeypatch.setattr(mod, "TrainLoop", _CaptureLoop)
        _CaptureLoop.captured = None
        try:
            call()
            out.append(_CaptureLoop.captured)
        except ValueError as e:
            out.append(e)
    return out


def test_init_from_pt_adoption_and_errors_match_jax_script(tmp_path, monkeypatch,
                                                           quiet_loggers):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LFVDM_COMPILE_CACHE", "")
    pt_cfg = dict(CFG64, num_channels=64, predict_xstart=True, rescale_learned_sigmas=False,
                  diffusion_space="pixel")
    model = write_reference_pt(tmp_path / "ref.pt", pt_cfg)
    base = ["--dataset", "synthetic", "--T", "8", "--sample_interval", "0",
            "--compute_dtype", "float32", "--init_from_pt", str(tmp_path / "ref.pt")]
    jax_kw, port_kw = _both_mains(monkeypatch, base)
    jcfg, tcfg = jax_kw["config"], port_kw["config"]
    assert tcfg["num_channels"] == 64 and tcfg["predict_xstart"] is True
    assert tcfg["diffusion_steps"] == 8 and tcfg["noise_schedule"] == "cosine"
    for key in video_train.ADOPT_KEYS + ("T", "in_channels", "diffusion_space"):
        assert tcfg[key] == jcfg[key], key
    assert set(port_kw["init_params"]) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(port_kw["init_params"][k], v, rtol=0, atol=0)

    # A pixel checkpoint on a pre-encoded dataset, and a checkpoint whose
    # channels the pixel space cannot take: the same errors.
    cases = [(pt_cfg, "carla_no_traffic_2x_encoded"),
             (dict(pt_cfg, in_channels=4), "synthetic")]
    for cfg, dataset in cases:
        write_reference_pt(tmp_path / "bad.pt", cfg)
        argv = ["--dataset", dataset, "--T", "8", "--sample_interval", "0",
                "--init_from_pt", str(tmp_path / "bad.pt")]
        jerr, terr = _both_mains(monkeypatch, argv)
        assert isinstance(jerr, ValueError) and isinstance(terr, ValueError)
        assert str(terr) == str(jerr)


@pytest.mark.parametrize("B,T,max_frames", [(1, 12, 4), (2, 12, 4), (2, 100, 20), (3, 60, 20)])
def test_make_vis_masks_equal_jax(B, T, max_frames):
    from lfvdm_tpu.training.vis_sampling import make_vis_masks as j_masks
    from lfvdm_tpu_torch.training.vis_sampling import make_vis_masks as t_masks

    got, want = t_masks(B, T, max_frames), j_masks(B, T, max_frames)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


def test_sample_fn_samples_with_the_ema_and_restores_the_weights(tmp_path, monkeypatch,
                                                                quiet_loggers):
    from lfvdm_tpu_torch.training.vis_sampling import make_sample_fn

    monkeypatch.chdir(tmp_path)
    loop = video_train.main(TRAIN_ARGS + ["--max_steps", "1", "--save_interval", "0",
                                          "--sample_interval", "0", "--log_interval", "0"])
    raw = {n: p.detach().clone() for n, p in loop.model.named_parameters()}
    vis = np.stack([get_test_dataset("synthetic", T=6)[i] for i in range(2)])
    vids = make_sample_fn(vis, out_dir=str(tmp_path / "vis"), seed=0)(loop)
    assert vids.shape == (2, 4, 3, 64, 64) and vids.dtype == np.uint8
    assert sorted(p.name for p in (tmp_path / "vis").iterdir()) == [
        f"step{loop.step:06d}_video{i}.gif" for i in range(2)]
    assert (vids[:, :1, 0, :, 1] == 255).all()  # the observed frame's red border
    for n, p in loop.model.named_parameters():
        assert torch.equal(p, raw[n])
    again = make_sample_fn(vis, out_dir=None, seed=0)(loop)
    np.testing.assert_array_equal(again, vids)  # seeded: the same window


def test_logger_jsonl_and_mean_across_processes(tmp_path, monkeypatch):
    """One process: values as logged, to stdout and metrics.jsonl. A group of
    two (a stand-in for torch.distributed whose other rank logged loss 3
    twice and a key of its own): the count-weighted mean over the union."""
    import torch.distributed as dist

    from lfvdm_tpu_torch.utils.logger import Logger

    lg = Logger()
    lg.configure(log_dir=str(tmp_path), use_wandb=True)  # no wandb here: stdout + JSONL
    lg.logkv_mean("loss", 1.0)
    lg.logkv("path", "a.gif", distributed=False)
    assert lg.dumpkvs() == {"loss": 1.0, "path": "a.gif"}
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["loss"] == 1.0

    other = {"loss": (3.0, 2.0), "only_other": (5.0, 1.0)}
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj, group=None: out.__setitem__(slice(None),
                                                                     [obj, sorted(other)]))

    def all_reduce(t, op=None, group=None):
        names = sorted({"loss", "only_other"})
        for i, n in enumerate(names):
            if n in other:
                t[i, 0] += other[n][0] * other[n][1]
                t[i, 1] += other[n][1]

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    lg.logkv_mean("loss", 1.0)
    out = lg.dumpkvs()
    assert out == {"loss": pytest.approx((1.0 + 6.0) / 3), "only_other": 5.0}
