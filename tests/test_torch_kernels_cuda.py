"""The CUDA kernels against their plain versions on the card, at edge shapes.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX). The flagship shapes
are checked by ``chip_smoke.py``; these cover ragged tiles, short and long
frame counts, odd widths, the launch counters and the input checks.
"""

import pytest
import torch

from lfvdm_tpu_torch.ops import attention as ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _tol(dtype, ref):
    """f32: accumulation order only. bf16: a few ulps of the output scale."""
    if dtype == torch.float32:
        return 1e-4
    return 2e-2 * ref.float().abs().max().item()


def _temporal(gen, B, H, T, F, D, dtype, n_pad):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    mask = torch.ones(B, T, device="cuda")
    if n_pad:
        mask[:, -n_pad:] = 0
    return (rnd(B, H, T, F, D, scale=F ** -0.5), rnd(B, H, T, F, D), rnd(B, H, T, F, D),
            rnd(B, H, T, T, F, scale=0.1), rnd(B, H, T, T, F, scale=0.1),
            rnd(B, H, T, F, T, scale=0.1), mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,F,D,n_pad", [
    (1, 1, 1, 8, 5, 0),       # one frame, ragged sites
    (2, 3, 7, 33, 70, 2),     # odd widths, ragged tiles, padding frames
    (1, 2, 32, 16, 40, 5),    # the most frames the kernel holds
    (2, 4, 20, 96, 256, 2),   # flagship ds 8
])
def test_temporal_kernel_matches_plain(cuda, dtype, B, H, T, F, D, n_pad):
    args = _temporal(cuda, B, H, T, F, D, dtype, n_pad)
    before = ops.temporal_rpe_attention.launches
    out = ops.temporal_rpe_attention(*args)
    ref = ops.temporal_rpe_attention_plain(*args)
    torch.cuda.synchronize()
    assert ops.temporal_rpe_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,F", [
    (1, 1, 1, 1, 4),          # a single token
    (1, 2, 3, 65, 33),        # one past a tile, odd width
    (2, 1, 2, 200, 128),      # widest head, ragged last tile
    (2, 20, 4, 64, 128),      # flagship ds 16
])
def test_spatial_kernel_matches_plain(cuda, dtype, B, T, H, D, F):
    def rnd(scale=1.0):
        return (torch.randn((B, T, H, D, F), generator=cuda, device="cuda") * scale).to(dtype)

    q, k, v = rnd(F ** -0.5), rnd(), rnd()
    before = ops.spatial_attention.launches
    out = ops.spatial_attention(q, k, v)
    ref = ops.spatial_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert ops.spatial_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


def test_non_contiguous_inputs(cuda):
    q, k, v = (torch.randn(2, 3, 4, 48, 40, generator=cuda, device="cuda").transpose(3, 4)
               for _ in range(3))  # (B, T, H, D=40, F=48), F not minor
    torch.testing.assert_close(ops.spatial_attention(q, k, v),
                               ops.spatial_attention_plain(q, k, v), atol=1e-4, rtol=1e-4)


def test_plain_impl_launches_nothing(cuda):
    args = _temporal(cuda, 1, 1, 4, 8, 8, torch.float32, 1)
    before = ops.launch_counts()
    ops.temporal_rpe_attention(*args, impl="plain")
    assert ops.launch_counts() == before


def test_out_of_range_inputs_raise(cuda):
    args = _temporal(cuda, 1, 1, 33, 8, 8, torch.float32, 0)
    with pytest.raises(ValueError):
        ops.temporal_rpe_attention(*args)
    q = torch.randn(1, 1, 1, 8, 136, device="cuda")
    with pytest.raises(ValueError):
        ops.spatial_attention(q, q, q)
    with pytest.raises(TypeError):
        h = q[..., :64].half()
        ops.spatial_attention(h, h, h)


def test_backward_replays_the_plain_version(cuda):
    q, k, v = (torch.randn(1, 2, 2, 70, 16, generator=cuda, device="cuda", requires_grad=True)
               for _ in range(3))
    g = torch.randn(1, 2, 2, 70, 16, generator=cuda, device="cuda")
    got = torch.autograd.grad(ops.spatial_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(ops.spatial_attention_plain(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
