"""Port vs JAX package: the fused skip projection's plain version and backward (CPU).

The port's layout is NCHW, (N, C, P) per part; the JAX op takes channels-last
rows (M, C) with M = N·P and ``n_samples`` = N. The same numpy arrays go
through both, transposed at the boundary.
"""

import functools

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
    assert tsc.skip_conv_stats.launches == 0
    assert ops.launch_counts()["skip_conv_stats"] == 0
    with pytest.raises(ValueError, match="impl"):
        tsc.skip_conv_stats(*args, impl="kernel")
