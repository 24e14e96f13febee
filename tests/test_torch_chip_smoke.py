"""chip_smoke.py's pieces that run without a card (CPU).

The spatial kernel's library yardstick, ``chip_smoke._sdpa``, must compute
the same function as the kernel: SDPA on the 4-D view (B·T, H, D, F) with
scale 1 against ``spatial_attention_plain``, in f32 (the backend pin is an
argument, left to PyTorch here). The ``kernels`` summary line carries every
key the line's readers take, and the script refuses to run without a card.
"""

import json

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
    launches = {n: 7 * 6 for n in chip_smoke.KERNEL_NAMES}
    routes = {"spatial_attention": {"mma": 42, "fma": 0},
              "skip_conv_stats": {"generic": 0, "bulk": 42}}
    latent = {n: k * 450 for n, k in chip_smoke.LATENT_PER_FORWARD.items()}
    latent_routes = {"spatial_attention": {"mma": 7 * 450, "fma": 0},
                     "skip_conv_stats": {"generic": 0, "bulk": 8 * 450}}
    line = chip_smoke.kernels_line(
        results, {"train": launches, "sample_video": launches, "latent_sample": latent},
        {"train": routes, "sample_video": routes, "latent_sample": latent_routes})
    json.dumps(line)
    entries = {e["name"]: e for e in line["kernels"]}
    assert set(entries) == set(chip_smoke.KERNEL_NAMES)
    for e in entries.values():
        assert CONTRACT_KEYS <= set(e) and e["route"] == "cuda"
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
    logged on the CPU (B=1, K=5, f32)."""
    from lfvdm_tpu_torch.config import create_model_and_diffusion, latent_config
    from lfvdm_tpu_torch.models import rpe, unet

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
    assert len(seen) == sum(chip_smoke.LATENT_PER_FORWARD.values())


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
