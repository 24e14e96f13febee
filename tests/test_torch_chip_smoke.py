"""chip_smoke.py's pieces that run without a card (CPU).

The spatial kernel's library yardstick, ``chip_smoke._sdpa``, must compute
the same function as the kernel: SDPA on the 4-D view (B·T, H, D, F) with
scale 1 against ``spatial_attention_plain``, in f32 (the backend pin is an
argument, left to PyTorch here). The ``kernels`` summary line carries every
key the line's readers take, and the script refuses to run without a card.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from lfvdm_tpu_torch.ops import attention as ops

CONTRACT_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.mark.parametrize("D", [1, 65, 200])
@pytest.mark.parametrize("F", [8, 96])
def test_sdpa_yardstick_computes_the_spatial_function(D, F):
    rng = np.random.default_rng(D * 1000 + F)
    shape = (2, 3, 2, D, F)  # (B, T, H, D, F)
    q = torch.from_numpy((rng.standard_normal(shape) * F ** -0.5).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    got = chip_smoke._sdpa(torch.nn.functional, None)(q, k, v)
    assert got.shape == q.shape
    torch.testing.assert_close(got, ops.spatial_attention_plain(q, k, v), atol=1e-5, rtol=1e-5)


def _row(name, ds, dtype="bfloat16", **extra):
    row = {"name": name, "ds": ds, "dtype": dtype, "max_abs_err": 0.01, "ms": 0.02,
           "plain_ms": 0.2, "library_ms": 0.01, "bound_ms": 0.004, "bytes": 1e7, "flops": 1e9}
    row.update(extra)
    return row


def _adamw_rows(results):
    """Phase 3's two rows of the optimizer kernel (f32 and bf16 EMA)."""
    for ema in ("float32", "bfloat16"):
        results[(chip_smoke.ADAMW_NAME, ema)] = _row(
            chip_smoke.ADAMW_NAME, None, ema_dtype=ema, bound_by="bytes", tensors=432,
            elements=80358147, kernel_launches_per_call=10, library="torch._fused_adamw_")
    return results


def test_kernels_line_has_every_key():
    results = {}
    for ds in chip_smoke.ATTN_SHAPES:
        results[("temporal_rpe_attention", ds, "bfloat16")] = _row("temporal_rpe_attention", ds,
                                                                   library_ms=None)
        results[("spatial_attention", ds, "bfloat16")] = _row(
            "spatial_attention", ds, route="mma", library="sdpa FLASH_ATTENTION")
    for ds in chip_smoke.LATENT_ATTN_SHAPES:
        results[("latent", "temporal_rpe_attention", ds, "bfloat16")] = _row(
            "temporal_rpe_attention", ds, library_ms=None, ms=0.005)
        results[("latent", "spatial_attention", ds, "bfloat16")] = _row(
            "spatial_attention", ds, route="mma", ms=0.005)
    for shp in chip_smoke.SKIP_SHAPES:
        results[("skip_conv_stats",) + shp + ("bfloat16",)] = _row("skip_conv_stats", shp[0])
    for shp in chip_smoke.LATENT_SKIP_SHAPES:
        results[("latent", "skip_conv_stats") + shp + ("bfloat16",)] = _row(
            "skip_conv_stats", shp[0], route="bulk", ms=0.003)
    _adamw_rows(results)
    for path, per in (("flagship", chip_smoke.PER_FORWARD),
                      ("latent", chip_smoke.LATENT_PER_FORWARD)):
        results[(chip_smoke.GN_NAME, path)] = _row(
            chip_smoke.GN_NAME, None, calls_per_forward=per[chip_smoke.GN_NAME],
            shape=[2, 20, 3, 128, 128], bound_by="bytes", bound_with_stats_read_ms=0.006,
            limit_violations=0, library="F.group_norm + F.silu")
    launches = {n: 7 * 6 for n in chip_smoke.KERNEL_NAMES}
    train = dict(launches, **{chip_smoke.GN_NAME: 0})
    sample = dict(launches, **{chip_smoke.GN_NAME: 35 * 6})
    routes = {"spatial_attention": {"mma": 42, "fma": 0},
              "skip_conv_stats": {"generic": 0, "bulk": 42}}
    latent = {n: k * 450 for n, k in chip_smoke.LATENT_PER_FORWARD.items()}
    latent_routes = {"spatial_attention": {"mma": 7 * 450, "fma": 0},
                     "skip_conv_stats": {"generic": 0, "bulk": 8 * 450}}
    line = chip_smoke.kernels_line(
        results, {"train": train, "sample_video": sample, "latent_sample": latent},
        {"train": routes, "sample_video": routes, "latent_sample": latent_routes})
    json.dumps(line)
    entries = {e["name"]: e for e in line["kernels"]}
    assert set(entries) == set(chip_smoke.KERNEL_NAMES) | {chip_smoke.ADAMW_NAME,
                                                           chip_smoke.GN_NAME}
    for e in entries.values():
        assert CONTRACT_KEYS <= set(e) and e["route"] == "cuda"
    # the fused norm kernel: phase 4b's flagship numbers, the latent's beside
    # them; its launches are the sampling path's, the other paths' beside them
    gn = entries[chip_smoke.GN_NAME]
    assert gn["launches"] == 35 * 6 and gn["source"] == chip_smoke.GN_SOURCE
    assert gn["launches_by_path"] == {"train": 0, "sample_video": 210, "latent_sample": 29 * 450}
    assert gn["limit_violations"] == 0
    assert gn["latent"]["ms"] == 0.02 and "29 calls" in gn["latent"]["unit"]
    # the optimizer kernel: its launches are the replays of phase 6b
    adamw = entries[chip_smoke.ADAMW_NAME]
    assert adamw["launches"] == sum(chip_smoke.FUSED_LAUNCHES.values())
    assert adamw["source"] == chip_smoke.ADAMW_SOURCE and "bf16_ema" in adamw
    spatial = entries["spatial_attention"]
    assert spatial["launches_by_route"]["train"] == routes["spatial_attention"]
    skip = entries["skip_conv_stats"]
    assert skip["launches_by_route"]["sample_video"] == routes["skip_conv_stats"]
    assert spatial["library"] == "sdpa FLASH_ATTENTION"
    assert spatial["ms"] == pytest.approx(0.02 * 7)
    assert entries["temporal_rpe_attention"]["library_ms"] is None
    # The latent path: its counts beside the others, and its own numbers.
    assert spatial["launches"] == 42 and spatial["launches_by_path"]["latent_sample"] == 3150
    assert skip["launches_by_route"]["latent_sample"] == latent_routes["skip_conv_stats"]
    lat = spatial["latent"]
    assert {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err"} <= set(lat)
    assert lat["ms"] == pytest.approx(0.005 * 7)
    assert [r["per_forward"] for r in lat["per_launch"]] == [3, 3, 1]
    assert len(skip["latent"]["per_launch"]) == 8
    assert skip["latent"]["ms"] == pytest.approx(0.003 * 8)
    assert entries["temporal_rpe_attention"]["latent"]["library_ms"] is None


def test_launch_check_requires_the_main_routes():
    """Every spatial launch on "mma" and every skip projection on "bulk"."""
    counts = {n: k * 2 for n, k in chip_smoke.PER_FORWARD.items()}
    good = {"spatial_attention": {"mma": 14, "fma": 0},
            "skip_conv_stats": {"generic": 0, "bulk": 20}}
    chip_smoke._check_launches(counts, good, 2)
    bad = dict(good, skip_conv_stats={"generic": 1, "bulk": 19})
    with pytest.raises(RuntimeError, match="route"):
        chip_smoke._check_launches(counts, bad, 2)


def test_latent_launch_check_takes_the_rules_routes():
    """The latent path: 7 + 7 + 8 launches per call on the routes the shape
    rules give (every latent shape is bf16 "mma" and "bulk")."""
    per_call = chip_smoke.latent_route_counts()
    assert per_call == {"spatial_attention": {"mma": 7}, "skip_conv_stats": {"bulk": 8}}
    counts = {n: k * 3 for n, k in chip_smoke.LATENT_PER_FORWARD.items()}
    good = {"spatial_attention": {"mma": 21, "fma": 0},
            "skip_conv_stats": {"generic": 0, "bulk": 24}}
    chip_smoke._check_launches(counts, good, 3, chip_smoke.LATENT_PER_FORWARD, per_call)
    with pytest.raises(RuntimeError, match="launch counts"):  # the flagship's 10 per call
        chip_smoke._check_launches(counts, good, 3)
    bad = dict(good, spatial_attention={"mma": 20, "fma": 1})
    with pytest.raises(RuntimeError, match="route"):
        chip_smoke._check_launches(counts, bad, 3, chip_smoke.LATENT_PER_FORWARD, per_call)


def test_latent_shapes_are_the_latent_unet_launches():
    """The latent shape tables match what one latent U-Net forward launches,
    logged on the CPU (B=1, K=5, f32), its 29 norm sites included."""
    from lfvdm_tpu_torch.config import create_model_and_diffusion, latent_config
    from lfvdm_tpu_torch.models import rpe, unet
    from lfvdm_tpu_torch.models.nn import GroupNorm32

    model, _ = create_model_and_diffusion(dict(latent_config(), compute_dtype="float32"),
                                          device="cpu")
    seen = []
    calls = {"spatial_attention": rpe.spatial_attention,
             "temporal_rpe_attention": rpe.temporal_rpe_attention,
             "skip_conv_stats": unet.skip_conv_stats}

    def spy(name, fn):
        def run(*args, **kw):
            seen.append((name, tuple(args[0].shape), tuple(args[1].shape)))
            return fn(*args, **kw)
        return run

    mp = pytest.MonkeyPatch()
    for name, fn in calls.items():
        mp.setattr(unet if name == "skip_conv_stats" else rpe, name, spy(name, fn))
    norm_silu = GroupNorm32.silu

    def norm_spy(self, h, **kw):  # every norm site, whichever route the CPU takes
        seen.append((chip_smoke.GN_NAME, tuple(h.shape), ()))
        return norm_silu(self, h, **kw)

    mp.setattr(GroupNorm32, "silu", norm_spy)
    try:
        B, K = chip_smoke.LATENT_B, chip_smoke.LATENT_K
        x = torch.randn(B, K, 4, 32, 32)
        obs = torch.zeros(B, K, 1, 1, 1)
        obs[:, :2] = 1
        with torch.no_grad():
            model(x, torch.tensor([3.0]), x0=x, frame_indices=torch.arange(K)[None],
                  obs_mask=obs, latent_mask=1 - obs)
    finally:
        mp.undo()
    spatial = sorted(s[1] for s in seen if s[0] == "spatial_attention")
    want = sorted((B, K, shp["H"], shp["D"], shp["F"])
                  for shp in chip_smoke.LATENT_ATTN_SHAPES.values()
                  for _ in range(shp["per_forward"]))
    assert spatial == want
    temporal = sorted(s[1] for s in seen if s[0] == "temporal_rpe_attention")
    assert temporal == sorted((b, h, t, f, d) for b, t, h, d, f in want)
    skip = sorted((s[1][1], s[2][1], s[1][2]) for s in seen if s[0] == "skip_conv_stats")
    assert skip == sorted((c1, c2, S) for _, c1, c2, _, S in chip_smoke.LATENT_SKIP_SHAPES)
    norms = sum(s[0] == chip_smoke.GN_NAME for s in seen)
    assert norms == chip_smoke.LATENT_PER_FORWARD[chip_smoke.GN_NAME]
    assert len(seen) == sum(chip_smoke.LATENT_PER_FORWARD.values())


def test_timed_batches_reads_each_batch_whole():
    seen = []

    def batches():
        while True:
            seen.append(1)
            yield np.zeros((2, 3), np.uint8)

    assert chip_smoke._timed_batches(batches(), 4) >= 0.0
    assert len(seen) == 2 + 4


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


# ---- the cli phase's pieces ----


def test_cli_fixture_is_the_carla_layout(tmp_path, monkeypatch):
    """The fixture writer gives the CARLA layout the registry reads: the
    train split with .npy siblings (the native loader's files), the test
    split without; the same seed, the same bytes."""
    from lfvdm_tpu_torch.data import datasets as data

    root = chip_smoke.write_carla_fixture(str(tmp_path / "a"), size=8, T=6, n_train=3,
                                          n_test=2)
    chip_smoke.write_carla_fixture(str(tmp_path / "b"), size=8, T=6, n_train=3, n_test=2)
    monkeypatch.setenv("DATA_ROOT", str(tmp_path / "a"))
    train = data.load_data(chip_smoke.CLI_DATASET, batch_size=1, T=6, return_dataset=True)
    test = data.get_test_dataset(chip_smoke.CLI_DATASET, T=6)
    assert isinstance(train, data.CarlaDataset) and (len(train), len(test)) == (3, 2)
    assert len(train.native_paths()) == 3 and test.native_paths() is None
    for i, path in enumerate(train.native_paths()):
        np.testing.assert_array_equal(train[i], train.postprocess_video(np.load(path)))
        assert (tmp_path / "b" / path.split(str(tmp_path / "a") + "/")[1]).read_bytes() == \
            open(path, "rb").read()
    assert test[1].shape == (6, 3, 8, 8) and root.endswith("datasets/carla/no-traffic")


def test_cli_reference_checkpoint_has_the_reference_keys(tmp_path):
    from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
    from lfvdm_tpu_torch.utils.convert import load_reference_checkpoint

    cfg = flagship_config(tiny=True)
    model, _ = create_model_and_diffusion(cfg, device="cpu", seed=3)
    path = str(tmp_path / "m.pt")
    config = chip_smoke.write_reference_checkpoint(path, model, cfg, dataset="synthetic",
                                                   max_frames=4)
    assert not set(config) & set(chip_smoke.REFERENCE_ONLY_DROPS)
    assert config["image_size"] == 32 and config["dataset"] == "synthetic"
    loaded, _, read = load_reference_checkpoint(path, device="cpu")
    assert read == config and loaded.dtype == torch.bfloat16  # the reference's torso default
    for (n, p), q in zip(model.named_parameters(), loaded.parameters()):
        assert torch.equal(p, q), n


def test_cli_observed_frame_check(tmp_path):
    from lfvdm_tpu_torch.data.datasets import get_test_dataset
    from lfvdm_tpu_torch.scripts.video_sample import to_uint8

    dataset = get_test_dataset("synthetic", T=6)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        video = to_uint8(dataset[i]).copy()
        video[3:] = rng.integers(0, 256, video[3:].shape, dtype=np.uint8)  # "sampled"
        paths.append(tmp_path / f"sample_{i:04d}-0.npy")
        np.save(paths[-1], video)
    chip_smoke.check_sample_files(paths, dataset, range(2), 3, (6, 3, 64, 64))
    with pytest.raises(RuntimeError, match="uint8"):
        chip_smoke.check_sample_files(paths, dataset, range(2), 3, (6, 3, 32, 32))
    with pytest.raises(RuntimeError, match="written"):
        chip_smoke.check_sample_files(paths[:1], dataset, range(2), 3, (6, 3, 64, 64))
    video = np.load(paths[1])
    video[2, 0, 0, 0] ^= 1  # one observed pixel off by one
    np.save(paths[1], video)
    with pytest.raises(RuntimeError, match="observed"):
        chip_smoke.check_sample_files(paths, dataset, range(2), 3, (6, 3, 64, 64))


def test_cli_train_flags_give_the_flagship_config(tmp_path, monkeypatch):
    """The cli phase's video_train command line, run to the TrainLoop on the
    CPU: the flagship config, its vis batch drawn from the native loader."""
    from lfvdm_tpu_torch.config import flagship_config
    from lfvdm_tpu_torch.scripts import video_train

    captured = {}

    class Capture:
        def __init__(self, **kw):
            captured.update(kw)

        def run_loop(self, max_steps=None):
            captured["max_steps"] = max_steps

    chip_smoke.write_carla_fixture(str(tmp_path), size=8, T=chip_smoke.CLI_VIDEO_T,
                                   n_train=2, n_test=1)
    monkeypatch.setenv("DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(video_train, "TrainLoop", Capture)
    from lfvdm_tpu_torch.utils.logger import logger

    monkeypatch.setattr(logger, "_jsonl_path", logger._jsonl_path)
    video_train.main(chip_smoke.cli_train_argv(str(tmp_path / "run")) + ["--device", "cpu"])
    config = captured["config"]
    assert {k: config[k] for k in flagship_config()} == flagship_config()
    assert captured["batch_size"] == chip_smoke.FLAGSHIP_B
    assert captured["max_frames"] == chip_smoke.FLAGSHIP_K
    assert captured["max_steps"] == chip_smoke.CLI_TRAIN_STEPS
    assert captured["sample_fn"] is not None
    from lfvdm_tpu_torch.data.native_loader import native_loader_available

    assert captured["data"].served == 1  # the vis batch
    assert captured["data"].source == ("native" if native_loader_available() else "python")


def test_cli_paths_in_the_kernels_line():
    """The cli phase's paths appear in launches_by_path and _by_route."""
    counts = {n: k * 125 for n, k in chip_smoke.PER_FORWARD.items()}
    routes = {"spatial_attention": {"mma": 7 * 125, "fma": 0},
              "skip_conv_stats": {"generic": 0, "bulk": 10 * 125}}
    chip_smoke._check_launches(counts, routes, 125)
    with pytest.raises(RuntimeError, match="launch counts"):
        chip_smoke._check_launches(counts, routes, 124)
    results = {}
    for ds in chip_smoke.ATTN_SHAPES:
        results[("temporal_rpe_attention", ds, "bfloat16")] = _row("temporal_rpe_attention",
                                                                   ds, library_ms=None)
        results[("spatial_attention", ds, "bfloat16")] = _row("spatial_attention", ds,
                                                              library="x")
    for ds in chip_smoke.LATENT_ATTN_SHAPES:
        for name in ("temporal_rpe_attention", "spatial_attention"):
            results[("latent", name, ds, "bfloat16")] = _row(name, ds)
    for shp in chip_smoke.SKIP_SHAPES:
        results[("skip_conv_stats",) + shp + ("bfloat16",)] = _row("skip_conv_stats", shp[0])
    for shp in chip_smoke.LATENT_SKIP_SHAPES:
        results[("latent", "skip_conv_stats") + shp + ("bfloat16",)] = _row("skip_conv_stats",
                                                                            shp[0])
    _adamw_rows(results)
    paths = ("train", "sample_video", "cli_sample", "cli_train", "cli_vis", "cli_run_dir_sample")
    line = chip_smoke.kernels_line(results, {p: counts for p in paths},
                                   {p: routes for p in paths})
    for e in line["kernels"][:len(chip_smoke.KERNEL_NAMES)]:  # the optimizer's comes last
        assert set(e["launches_by_path"]) == set(paths)
        assert e["launches_by_path"]["cli_sample"] == counts[e["name"]]


# ---- the reuse phase's pieces ----


def test_reuse_counts_are_the_flagship_structure():
    """The reuse and heatmap launch counts that phase 5b requires are what a
    U-Net of the flagship's structure (128 px, one res block, attention at ds
    8 and 16; narrow channels here) derives, and a window's mixed count is
    full calls x 7 + 7 + 10 plus reuse calls x 4 + 4 + 10, and the fused
    norm's 35 a full call and 21 a reuse call."""
    from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config
    from lfvdm_tpu_torch.models.unet import attention_blocks, fused_skip_blocks

    cfg = dict(flagship_config(), num_channels=32, compute_dtype="float32")
    model, _ = create_model_and_diffusion(cfg, device="cpu")
    assert (attention_blocks(model), fused_skip_blocks(model)) == (7, 10)
    assert chip_smoke.reuse_forward_counts(model) == (chip_smoke.REUSE_PER_FORWARD,
                                                      chip_smoke.ATTN_PER_FORWARD)
    assert chip_smoke.mixed_counts(17, 33) == {"temporal_rpe_attention": 7 * 17 + 4 * 33,
                                               "spatial_attention": 7 * 17 + 4 * 33,
                                               "skip_conv_stats": 10 * 50,
                                               chip_smoke.GN_NAME: 35 * 17 + 21 * 33}
    counts = chip_smoke.mixed_counts(17, 33)
    good = {"spatial_attention": {"mma": 251, "fma": 0},
            "skip_conv_stats": {"generic": 0, "bulk": 500}}
    chip_smoke._check_launches(counts, good, 1, counts)
    with pytest.raises(RuntimeError, match="launch counts"):  # 50 full calls' counts
        chip_smoke._check_launches(counts, good, 50)


# ---- the serve phase's pieces ----


def test_serve_paths_in_the_kernels_line():
    """Phase 5c's paths: the DDIM artifact's 25 steps and the ancestral one's
    50 each launch 7 + 7 + 10 kernels per step on "mma"/"bulk", and both
    paths appear in the kernels line by count and by route."""
    per_path = {}
    for path, steps in (("serve", 25), ("serve_ancestral", 50)):
        counts = {n: k * steps for n, k in chip_smoke.PER_FORWARD.items()}
        routes = {"spatial_attention": {"mma": 7 * steps, "fma": 0},
                  "skip_conv_stats": {"generic": 0, "bulk": 10 * steps}}
        chip_smoke._check_launches(counts, routes, steps)
        with pytest.raises(RuntimeError, match="launch counts"):
            chip_smoke._check_launches(counts, routes, steps - 1)
        per_path[path] = (counts, routes)
    wrong_route = {"spatial_attention": {"mma": 7 * 24, "fma": 7},
                   "skip_conv_stats": {"generic": 0, "bulk": 250}}
    with pytest.raises(RuntimeError, match="by route"):
        chip_smoke._check_launches(per_path["serve"][0], wrong_route, 25)
    results = {}
    for ds in chip_smoke.ATTN_SHAPES:
        for name in ("temporal_rpe_attention", "spatial_attention"):
            results[(name, ds, "bfloat16")] = _row(name, ds, library="x")
    for ds in chip_smoke.LATENT_ATTN_SHAPES:
        for name in ("temporal_rpe_attention", "spatial_attention"):
            results[("latent", name, ds, "bfloat16")] = _row(name, ds)
    for shp in chip_smoke.SKIP_SHAPES:
        results[("skip_conv_stats",) + shp + ("bfloat16",)] = _row("skip_conv_stats", shp[0])
    for shp in chip_smoke.LATENT_SKIP_SHAPES:
        results[("latent", "skip_conv_stats") + shp + ("bfloat16",)] = _row("skip_conv_stats",
                                                                            shp[0])
    _adamw_rows(results)
    paths = {"train": per_path["serve"], **per_path}
    line = chip_smoke.kernels_line(results, {p: c for p, (c, _) in paths.items()},
                                   {p: r for p, (_, r) in paths.items()})
    assert line["kernels"][-1]["name"] == chip_smoke.ADAMW_NAME
    for e in line["kernels"][:-1]:  # the U-Net's kernels, on the serving paths
        assert CONTRACT_KEYS <= set(e)
        assert e["launches_by_path"]["serve"] == 25 * chip_smoke.PER_FORWARD[e["name"]]
        assert e["launches_by_path"]["serve_ancestral"] == 50 * chip_smoke.PER_FORWARD[e["name"]]
        if e["name"] in chip_smoke.ROUTED:
            assert e["launches_by_route"]["serve"] == per_path["serve"][1][e["name"]]


def test_serving_process_blocks_the_model_code():
    """The serving subprocess's code compiles, and its import blocker covers
    the model, config, diffusion and sampling modules and the JAX side."""
    import ast

    code = chip_smoke.SERVE_CHILD.format(blocked=chip_smoke.SERVE_BLOCKED, timed=2)
    ast.parse(code)
    for name in ("lfvdm_tpu_torch.models", "lfvdm_tpu_torch.config", "lfvdm_tpu_torch.sampling",
                 "lfvdm_tpu_torch.diffusion", "jax", "lfvdm_tpu"):
        assert name in chip_smoke.SERVE_BLOCKED
    assert "lfvdm_tpu_torch.ops" not in code.split("BLOCKED =")[1].split("\n")[0]


def test_lpips_stand_in_is_the_lpips_distance(tmp_path, monkeypatch):
    """Phase 11's ``lpips`` stand-in computes the LPIPS distance as the
    ``lpips`` package does (the independent fixture, given the same
    weights), and ``convert_lpips.main`` drives it as it drives the package."""
    import sys
    from pathlib import Path

    from lfvdm_tpu_torch.scripts import convert_lpips

    sys.path.insert(0, str(Path(__file__).resolve().parent / "fixtures"))
    try:
        import torch_lpips_fixture
    finally:
        sys.path.pop(0)
    libraries, made = chip_smoke.stand_in_libraries(3)
    monkeypatch.setitem(sys.modules, "lpips", libraries["lpips"])
    out = str(tmp_path / "lpips_alex.npz")
    convert_lpips.main(["--out", out, "--device", "cpu"])
    stand_in, ref = made["lpips"], torch_lpips_fixture.LPIPS().eval()
    ours = [m for m in stand_in.net.modules() if isinstance(m, torch.nn.Conv2d)]
    theirs = [m for m in ref.net.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        for a, b in zip(ours, theirs):
            b.weight.copy_(a.weight)
            b.bias.copy_(a.bias)
        for a, b in zip(stand_in.lins, ref.lins):
            b.model[-1].weight.copy_(a.model[-1].weight)
        x, y = (torch.rand((3, 3, 64, 64), generator=torch.Generator().manual_seed(s)) * 2 - 1
                for s in (1, 2))
        torch.testing.assert_close(stand_in(x, y), ref(x, y), rtol=1e-5, atol=1e-7)


def test_update_and_remat_arms_set_and_restore_their_variables(monkeypatch):
    """Phase 6b's update arms and phase 7b a's remat arms run under
    ``_environ``: the switches hold inside and the variables are as they
    were after (unset ones unset), also when the body raises."""
    monkeypatch.setenv("LFVDM_REMAT_POLICY", "nothing")
    monkeypatch.delenv("LFVDM_BF16_EMA", raising=False)
    env = dict(chip_smoke.EMA_ARMS["bf16_ema"], LFVDM_REMAT_POLICY="dots")
    with pytest.raises(KeyError):
        with chip_smoke._environ(env):
            assert {k: os.environ[k] for k in env} == env
            raise KeyError("inside")
    assert os.environ["LFVDM_REMAT_POLICY"] == "nothing"
    assert "LFVDM_BF16_EMA" not in os.environ
    assert chip_smoke._arm_name(chip_smoke.EMA_ARMS["bf16_ema"]) == "bf16_ema"
    assert chip_smoke._arm_name({}) == "default"
    assert set(chip_smoke.REMAT_ARMS) == {"gn_stats", "nothing", "dots", "everything"}
    assert set(chip_smoke.REMAT_BITWISE) | set(chip_smoke.REMAT_RECOMPUTES_KERNELS) <= set(
        chip_smoke.REMAT_ARMS)
