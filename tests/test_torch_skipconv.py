"""Port vs JAX package: the fused skip projection's plain version and backward (CPU).

The port's layout is NCHW, (N, C, P) per part; the JAX op takes channels-last
rows (M, C) with M = N·P and ``n_samples`` = N. The same numpy arrays go
through both, transposed at the boundary.
"""

import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lfvdm_tpu.ops import skipconv as jsc
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.ops import skipconv as tsc


def make(seed, N, c1, c2, F, P, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return dict(x1=rng.standard_normal((N, c1, P)).astype(dtype),
                x2=rng.standard_normal((N, c2, P)).astype(dtype),
                w=(rng.standard_normal((F, c1 + c2)) * 0.05).astype(dtype),
                b=(rng.standard_normal(F) * 0.05).astype(dtype),
                resid=rng.standard_normal((N, F, P)).astype(dtype))


def rows(a):
    """(N, C, P) -> (N·P, C): the JAX op's layout."""
    return np.ascontiguousarray(a.transpose(0, 2, 1).reshape(-1, a.shape[1]))


def unrows(a, N):
    """(N·P, C) -> (N, C, P)."""
    a = np.asarray(a, np.float32)
    return a.reshape(N, -1, a.shape[-1]).transpose(0, 2, 1)


def jax_args(d, dtype=jnp.float32):
    return (jnp.asarray(rows(d["x1"]), dtype), jnp.asarray(rows(d["x2"]), dtype),
            jnp.asarray(d["w"].T, dtype), jnp.asarray(d["b"], dtype),
            jnp.asarray(rows(d["resid"]), dtype))


def torch_args(d, dtype=torch.float32, requires_grad=False):
    return [torch.from_numpy(d[k]).to(dtype).requires_grad_(requires_grad)
            for k in ("x1", "x2", "w", "b", "resid")]


@pytest.mark.parametrize("N,c1,c2,F,P", [(2, 24, 40, 36, 90), (3, 128, 64, 96, 64)])
def test_plain_matches_jax_reference(N, c1, c2, F, P):
    d = make(0, N, c1, c2, F, P)
    jy, js1, js2 = jsc._fwd_xla(*jax_args(d), N)
    y, s1, s2 = tsc.skip_conv_stats_plain(*torch_args(d))
    np.testing.assert_allclose(y.numpy(), unrows(jy, N), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), atol=1e-5 * np.abs(js1).max(),
                               rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), atol=1e-5 * np.abs(js2).max(),
                               rtol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernel in interpret mode with a row block that tiles small
    shapes (as tests/test_skipconv.py runs it)."""
    monkeypatch.setattr(jsc.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jsc, "_BLK", 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_pallas_kernel(interpret, dtype):
    N, P = 2, 512
    d = make(1, N, 128, 128, 128, P)
    jy, js1, js2 = jsc._fwd_pallas(*jax_args(d, getattr(jnp, dtype)), N)
    y, s1, s2 = tsc.skip_conv_stats_plain(*torch_args(d, getattr(torch, dtype)))
    assert y.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(y.float().numpy(), unrows(jy, N), rtol=2e-2, atol=2e-2)
    for got, ref in ((s1, js1), (s2, js2)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())


def test_backward_matches_jax_vjp():
    N, c1, c2, F, P = 2, 20, 28, 24, 35
    d = make(2, N, c1, c2, F, P)
    rng = np.random.default_rng(3)
    gy = rng.standard_normal((N, F, P)).astype(np.float32)
    gs1 = rng.standard_normal((N, F)).astype(np.float32)
    gs2 = (rng.standard_normal((N, F)) * 0.1).astype(np.float32)

    _, vjp = jax.vjp(lambda *a: jsc.skip_conv_stats(*a, N, False), *jax_args(d))
    jdx1, jdx2, jdw, jdb, jdr = vjp((jnp.asarray(rows(gy)), jnp.asarray(gs1), jnp.asarray(gs2)))

    args = torch_args(d, requires_grad=True)
    out = tsc.skip_conv_stats(*args)
    dx1, dx2, dw, db, dr = torch.autograd.grad(
        out, args, (torch.from_numpy(gy), torch.from_numpy(gs1), torch.from_numpy(gs2)))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dx1.numpy(), unrows(jdx1, N), **tol)
    np.testing.assert_allclose(dx2.numpy(), unrows(jdx2, N), **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw).T, atol=1e-5 * np.abs(jdw).max(),
                               rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=1e-5 * np.abs(jdb).max(),
                               rtol=1e-5)
    np.testing.assert_allclose(dr.numpy(), unrows(jdr, N), **tol)


def test_nchw_inputs_and_conv_weight_shape():
    """4-D activations and the conv's (F, K, 1, 1) weight give the flat result."""
    N, c1, c2, F, H, W = 2, 6, 10, 8, 3, 5
    d = make(4, N, c1, c2, F, H * W)
    x1, x2, w, b, r = torch_args(d)
    flat = tsc.skip_conv_stats(x1, x2, w, b, r)
    nchw = tsc.skip_conv_stats(x1.reshape(N, c1, H, W), x2.reshape(N, c2, H, W),
                               w.reshape(F, c1 + c2, 1, 1), b, r.reshape(N, F, H, W))
    assert nchw[0].shape == (N, F, H, W)
    torch.testing.assert_close(nchw[0].reshape(N, F, -1), flat[0], atol=0, rtol=0)
    torch.testing.assert_close(nchw[1], flat[1], atol=0, rtol=0)


def test_cpu_calls_launch_no_kernel():
    ops.reset_launch_counts()
    args = torch_args(make(5, 2, 4, 4, 4, 9))
    tsc.skip_conv_stats(*args)
    tsc.skip_conv_stats(*args, impl="plain")
    bf16 = [a.to(torch.bfloat16) for a in torch_args(make(6, 2, 16, 16, 16, 64))]
    tsc.skip_conv_stats(*bf16)  # a shape the card would put on the bulk route
    assert tsc.skip_conv_stats.launches == 0
    assert tsc.skip_conv_stats.launches_by_route == {"generic": 0, "bulk": 0}
    assert ops.launch_counts()["skip_conv_stats"] == 0
    with pytest.raises(ValueError, match="impl"):
        tsc.skip_conv_stats(*args, impl="kernel")


# The launch plan (pure Python; the C function refuses any other plan, which
# the card tests check against the library's own).

FLAGSHIP_N = chip_smoke.FLAGSHIP_B * chip_smoke.FLAGSHIP_K


@pytest.mark.parametrize("shape", list(dict.fromkeys(chip_smoke.SKIP_SHAPES)),
                         ids=lambda s: "-".join(map(str, s)))
def test_flagship_shapes_plan_the_bulk_route(shape):
    _, c1, c2, F, S = shape
    N, P = FLAGSHIP_N, S * S
    p = tsc.plan(N, c1, c2, F, P, torch.bfloat16)
    assert p.route == "bulk"
    assert 0 < p.smem <= tsc.SMEM_MAX == 232448  # the H100's 227 KB a block
    assert p.smem == tsc._bulk_smem(p.bn, c1 + c2, p.w_resident, p.stages)
    assert 2 <= p.stages <= tsc.MAX_STAGES
    # partial holds one sum per (sample, pixel tile, channel): the tiles cover P exactly once.
    assert (p.p_tiles - 1) * p.bn < P <= p.p_tiles * p.bn
    tiles = N * p.p_tiles * -(-F // p.bm)
    assert p.grid == min(tiles, tsc.H100_SMS)  # persistent: one CTA per SM
    # w stays resident where one channel tile covers F and K is small (ds 1, ds 2).
    assert p.w_resident == (F <= p.bm and c1 + c2 <= tsc.W_RESIDENT_MAX_K)
    assert p.bn == (128 if P >= 128 else 64)
    assert len(p.fields()) == 8 and p.fields()[0] == 1


@pytest.mark.parametrize("why,N,c1,c2,F,P,dtype,aligned", [
    ("f32", FLAGSHIP_N, 128, 128, 128, 128 * 128, torch.float32, True),
    ("odd widths", 2, 17, 5, 9, 35, torch.bfloat16, True),
    ("c2 % 16", 2, 64, 72, 136, 72, torch.bfloat16, True),
    ("P % 8", 3, 32, 32, 64, 66, torch.bfloat16, True),
    ("unaligned", 2, 64, 64, 64, 64, torch.bfloat16, False),
])
def test_other_inputs_plan_the_generic_route(why, N, c1, c2, F, P, dtype, aligned):
    p = tsc.plan(N, c1, c2, F, P, dtype, aligned=aligned)
    assert p.route == "generic" and p.smem == 0 and p.fields()[0] == 0
    assert (p.bm, p.bn, p.p_tiles) == (64, 64, -(-P // 64))
    assert p.grid == p.p_tiles * -(-F // 64) * N


def test_plan_sizes_the_ring_to_shared_memory():
    """w resident at ds 2's K = 384 leaves room for 3 stages, at K = 256 for
    4; past the limit on K, w streams through the ring."""
    ds2 = tsc.plan(FLAGSHIP_N, 256, 128, 128, 64 * 64, torch.bfloat16)
    assert ds2.w_resident and ds2.stages == 3
    ds1 = tsc.plan(FLAGSHIP_N, 128, 128, 128, 128 * 128, torch.bfloat16)
    assert ds1.w_resident and ds1.stages == 4 and ds1.smem == 211200
    wide = tsc.plan(FLAGSHIP_N, 256, 256, 128, 64 * 64, torch.bfloat16)
    assert not wide.w_resident and wide.stages == 4
    small = tsc.plan(1, 16, 16, 8, 64, torch.bfloat16, sms=4)
    assert small.route == "bulk" and small.grid == 1  # one tile, one CTA
    with pytest.raises(ValueError):
        tsc.plan(0, 16, 16, 8, 64, torch.bfloat16)
