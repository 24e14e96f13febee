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
    for shp in chip_smoke.SKIP_SHAPES:
        results[("skip_conv_stats",) + shp + ("bfloat16",)] = _row("skip_conv_stats", shp[0])
    launches = {n: 7 * 6 for n in chip_smoke.KERNEL_NAMES}
    routes = {"spatial_attention": {"mma": 42, "fma": 0},
              "skip_conv_stats": {"generic": 0, "bulk": 42}}
    line = chip_smoke.kernels_line(results, {"train": launches, "sample_video": launches},
                                   {"train": routes, "sample_video": routes})
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


def test_launch_check_requires_the_main_routes():
    """Every spatial launch on "mma" and every skip projection on "bulk"."""
    counts = {n: k * 2 for n, k in chip_smoke.PER_FORWARD.items()}
    good = {"spatial_attention": {"mma": 14, "fma": 0},
            "skip_conv_stats": {"generic": 0, "bulk": 20}}
    chip_smoke._check_launches(counts, good, 2)
    bad = dict(good, skip_conv_stats={"generic": 1, "bulk": 19})
    with pytest.raises(RuntimeError, match="route"):
        chip_smoke._check_launches(counts, bad, 2)


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
