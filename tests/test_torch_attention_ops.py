"""The attention kernels' plain versions and wrappers against the JAX package's
einsum oracles (``lfvdm_tpu.ops.attention.*_reference``), on the CPU.

On the CPU each wrapper takes its plain version, so these tests pin the
function every CUDA kernel is held to on the card (chip_smoke.py and
test_torch_kernels_cuda.py) to the JAX package's definition.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.ops.attention import spatial_attention_reference, temporal_rpe_attention_reference
from lfvdm_tpu_torch.ops import attention as ops

TOL = dict(atol=1e-5, rtol=1e-5)


def temporal_inputs(seed, B=2, H=2, T=5, F=8, D=16, mask="two-group"):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = [rnd(B, H, T, F, D, scale=F ** -0.5), rnd(B, H, T, F, D), rnd(B, H, T, F, D),
              rnd(B, H, T, T, F, scale=0.1), rnd(B, H, T, T, F, scale=0.1),
              rnd(B, H, T, F, T, scale=0.1)]
    if mask == "two-group":
        m = np.ones((B, T), np.float32)
        m[0, -2:] = 0.0  # padding frames
        m[-1, 1] = 0.0
    else:
        m = np.ones((B, T), np.float32)
    return arrays + [m]


def spatial_inputs(seed, B=2, T=3, H=2, D=16, F=8):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, H, D, F)) * F ** -0.5).astype(np.float32)
    return [q] + [rng.standard_normal((B, T, H, D, F)).astype(np.float32) for _ in range(2)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("mask", ["two-group", "all"])
def test_temporal_plain_matches_jax_reference(mask):
    args = temporal_inputs(0, mask=mask)
    ref = np.asarray(temporal_rpe_attention_reference(*_jax(args)))
    out = ops.temporal_rpe_attention_plain(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("mask", ["two-group", "all"])
def test_temporal_wrapper_matches_jax_reference(mask):
    args = temporal_inputs(1, mask=mask)
    ref = np.asarray(temporal_rpe_attention_reference(*_jax(args)))
    out = ops.temporal_rpe_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_spatial_plain_and_wrapper_match_jax_reference():
    args = spatial_inputs(2)
    ref = np.asarray(spatial_attention_reference(*_jax(args)))
    np.testing.assert_allclose(ops.spatial_attention_plain(*_torch(args)).numpy(), ref, **TOL)
    np.testing.assert_allclose(ops.spatial_attention(*_torch(args)).numpy(), ref, **TOL)


def _bf16_rounded(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays]


def test_bf16_plain_versions_track_the_f32_references():
    """In bf16 the plain versions take f32 products of the bf16 inputs and
    round the weights and the output to bf16 (as the JAX references do;
    XLA:CPU has no bf16 dot, so the reference runs in f32 on the same
    bf16-rounded inputs). Tolerance: a few bf16 ulps of O(1) outputs."""
    t_args = temporal_inputs(3)
    t_in = _bf16_rounded(t_args[:6]) + [t_args[6]]
    ref = np.asarray(temporal_rpe_attention_reference(*_jax(t_in)))
    out = ops.temporal_rpe_attention_plain(*_torch(t_args[:6], torch.bfloat16),
                                           torch.from_numpy(t_args[6]))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)
    s_in = _bf16_rounded(spatial_inputs(4))
    ref = np.asarray(spatial_attention_reference(*_jax(s_in)))
    out = ops.spatial_attention_plain(*_torch(s_in, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_two_group_mask_isolates_groups():
    """Changing the values of mask-0 frames leaves the mask-1 frames' output alone."""
    args = _torch(temporal_inputs(5))
    out = ops.temporal_rpe_attention(*args)
    m = args[6]
    pad = (m[0] == 0).nonzero().flatten()
    k2, v2 = args[1].clone(), args[2].clone()
    k2[0, :, pad] += 3.0
    v2[0, :, pad] -= 2.0
    out2 = ops.temporal_rpe_attention(args[0], k2, v2, *args[3:])
    real = (m[0] == 1).nonzero().flatten()
    torch.testing.assert_close(out2[0, :, real], out[0, :, real], atol=0, rtol=0)
    assert not torch.allclose(out2[0, :, pad], out[0, :, pad])


def test_cpu_calls_launch_no_kernel():
    ops.reset_launch_counts()
    ops.temporal_rpe_attention(*_torch(temporal_inputs(6)))
    ops.spatial_attention(*_torch(spatial_inputs(6)))
    ops.temporal_rpe_attention(*_torch(temporal_inputs(6)), impl="plain")
    assert ops.launch_counts() == {"temporal_rpe_attention": 0, "spatial_attention": 0}


def test_impl_must_be_auto_or_plain():
    with pytest.raises(ValueError):
        ops.spatial_attention(*_torch(spatial_inputs(7)), impl="kernel")


def _grads(fn, args, n_diff, seed):
    leaves = [a.clone().requires_grad_(i < n_diff) for i, a in enumerate(args)]
    out = fn(*leaves)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(out.shape).astype(np.float32))
    return torch.autograd.grad(out, leaves[:n_diff], g)


def test_temporal_backward_replays_the_plain_version():
    """The wrapper's autograd.Function backward equals autograd through the
    plain version (for q, k, v and the three r tables; the mask has none)."""
    args = _torch(temporal_inputs(8, B=1, H=1, T=4, F=4, D=8))
    got = _grads(ops.temporal_rpe_attention, args, 6, 9)
    want = _grads(ops.temporal_rpe_attention_plain, args, 6, 9)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def test_spatial_backward_replays_the_plain_version():
    args = _torch(spatial_inputs(10, B=1, T=2, H=1, D=8, F=4))
    got = _grads(ops.spatial_attention, args, 3, 11)
    want = _grads(ops.spatial_attention_plain, args, 3, 11)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
