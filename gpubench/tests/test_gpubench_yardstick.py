"""The benchmark's fixed arithmetic against the per-launch bounds the
port's kernel table records (``PERF.md``, "TPU kernels of the repo and
their ports": flagship B=2, K=20, bf16) and the update's bound."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from yardstick import bound_s, spatial_work, temporal_work, update_work  # noqa: E402

FLAGSHIP = {"image_size": 128, "in_channels": 3, "num_channels": 128, "num_res_blocks": 1,
            "num_heads": 4, "attention_resolutions": "16,8", "compute_dtype": "bfloat16"}
FLAGSHIP_PARAMETERS = 80_358_147


@pytest.mark.parametrize("work, want_ms", [
    (temporal_work(B=2, H=4, T=20, D=256, F=96, esize=2), 0.0099),   # ds 8
    (temporal_work(B=2, H=4, T=20, D=64, F=128, esize=2), 0.0039),   # ds 16
    (spatial_work(B=2, T=20, H=4, D=256, F=96, esize=2), 0.0094),    # ds 8
    (spatial_work(B=2, T=20, H=4, D=64, F=128, esize=2), 0.0031),    # ds 16
    (update_work(FLAGSHIP_PARAMETERS, 1), 0.864),                   # AdamW + one f32 EMA
])
def test_per_launch_bounds(work, want_ms):
    nbytes, flops = work
    assert bound_s(nbytes, flops, "bfloat16" if want_ms < 0.1 else "float32") * 1e3 == \
        pytest.approx(want_ms, rel=0.01)


def test_flagship_forward_counts():
    """The launches of one flagship forward and their least time (the
    table's per-forward bounds: temporal 0.045, spatial 0.041, skip 0.590
    ms), and its parameter count, from the reference on the meta device."""
    import torch

    from reference.unet import UNet
    from work import unet_forward

    got = unet_forward(FLAGSHIP, 2, 20)
    assert got["launches"] == {"temporal_rpe_attention": 7, "spatial_attention": 7,
                               "skip_conv_stats": 10}
    ms = {k: v * 1e3 for k, v in got["kernels"].items()}
    assert ms["temporal_rpe_attention"] == pytest.approx(0.045, abs=0.001)
    assert ms["spatial_attention"] == pytest.approx(0.041, abs=0.001)
    assert ms["skip_conv_stats"] == pytest.approx(0.590, abs=0.001)
    with torch.device("meta"):
        model = UNet(FLAGSHIP)
    assert sum(p.numel() for p in model.parameters()) == FLAGSHIP_PARAMETERS
