"""The CUDA kernels against their plain versions on the card, at edge shapes.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX). The flagship shapes
are checked by ``chip_smoke.py``; these cover ragged tiles, short and long
frame counts, odd widths, both routes of the spatial kernel, the launch
counters, the input checks and the skip projection's backward.
"""

import pytest
import torch

from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.ops import skipconv

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
    (1, 2, 32, 16, 40, 5),    # one full chunk of 32 keys
    (1, 2, 33, 24, 40, 3),    # one key past a chunk, ragged sites
    (2, 1, 40, 33, 70, 4),    # two key chunks, odd width, ragged sites
    (1, 3, 64, 16, 5, 7),     # two full key chunks, fewer sites than a warp
    (2, 4, 20, 96, 256, 2),   # flagship ds 8
    (2, 4, 20, 128, 64, 2),   # flagship ds 16
    (1, 4, 5, 32, 256, 0),    # latent ds 2: 5 frames, one query block
    (1, 4, 5, 32, 64, 2),     # latent ds 4, padding frames
    (1, 4, 5, 32, 16, 0),     # latent middle block: 16 sites, half a warp
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


def test_temporal_kernel_is_deterministic(cuda):
    """No atomics: two launches on the same inputs are bitwise equal."""
    for T, D in ((20, 256), (40, 70)):
        args = _temporal(cuda, 2, 4, T, 96, D, torch.bfloat16, 2)
        first = ops.temporal_rpe_attention(*args)
        assert torch.equal(first, ops.temporal_rpe_attention(*args))


def _spatial(gen, B, T, H, D, F, dtype):
    def rnd(scale=1.0):
        return (torch.randn((B, T, H, D, F), generator=gen, device="cuda") * scale).to(dtype)

    return rnd(F ** -0.5), rnd(), rnd()


def _check_spatial(q, k, v, route):
    """One launch on ``route`` (the kernel's counters), within _tol of the plain version."""
    before = ops.spatial_attention.launches
    by_route = dict(ops.spatial_attention.launches_by_route)
    out = ops.spatial_attention(q, k, v)
    ref = ops.spatial_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert ops.spatial_attention.launches == before + 1
    assert ops.spatial_attention.launches_by_route[route] == by_route[route] + 1
    assert out.dtype == q.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(q.dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,F", [
    (1, 1, 1, 1, 4),          # a single token
    (1, 2, 3, 65, 33),        # one past a tile, odd width
    (2, 1, 2, 200, 128),      # widest head, ragged last tile
    (2, 20, 4, 64, 128),      # flagship ds 16
    (1, 5, 4, 256, 32),       # latent ds 2
    (1, 5, 4, 64, 32),        # latent ds 4: one query block
    (1, 5, 4, 16, 32),        # latent middle block: a quarter of a tile
])
def test_spatial_kernel_matches_plain(cuda, dtype, B, T, H, D, F):
    route = "mma" if dtype == torch.bfloat16 and F % 16 == 0 else "fma"
    _check_spatial(*_spatial(cuda, B, T, H, D, F, dtype), route)


@pytest.mark.parametrize("B,T,H,D,F", [
    *[(2, 1, 3, D, F) for D in (1, 65, 200) for F in (16, 96, 128)],  # ragged D, each width
    *[(2, 1, 3, D, 32) for D in (1, 16, 65, 200)],  # the latent config's width
    (2, 20, 4, 256, 96),      # flagship ds 8
])
def test_spatial_mma_route_matches_plain(cuda, B, T, H, D, F):
    _check_spatial(*_spatial(cuda, B, T, H, D, F, torch.bfloat16), "mma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,F", [
    (1, 2, 2, 65, 136),       # one column past a feature chunk, ragged token tile
    (1, 1, 3, 70, 192),       # a chunk and a half
    (2, 1, 2, 64, 256),       # two full chunks
    (1, 2, 1, 130, 384),      # three chunks, three token tiles
])
def test_spatial_wide_heads_take_the_fma_route(cuda, dtype, B, T, H, D, F):
    """F > 128 (the JAX kernel takes any F): the FMA route, in feature chunks."""
    _check_spatial(*_spatial(cuda, B, T, H, D, F, dtype), "fma")


def test_spatial_unaligned_view_takes_the_fma_route(cuda):
    """bf16 views one element past the start of a row: same function, FMA route."""
    shape = (1, 2, 2, 70, 32)
    n = torch.Size(shape).numel()
    buf = torch.randn(3, n + 1, generator=cuda, device="cuda")
    buf[0] *= shape[-1] ** -0.5
    q, k, v = (row[1:].view(shape) for row in buf.to(torch.bfloat16))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    _check_spatial(q, k, v, "fma")


def test_spatial_kernel_is_deterministic(cuda):
    """Two launches of the mma route on the same inputs are bitwise equal."""
    args = _spatial(cuda, 2, 20, 4, 256, 96, torch.bfloat16)
    first = ops.spatial_attention(*args)
    assert torch.equal(first, ops.spatial_attention(*args))


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
    """T = 33 and F = 136, once past the kernels' limits, now launch once each
    and match the plain versions; fp16 and too many frames still raise."""
    args = _temporal(cuda, 1, 1, 33, 8, 8, torch.float32, 0)
    before = ops.temporal_rpe_attention.launches
    out = ops.temporal_rpe_attention(*args)
    assert ops.temporal_rpe_attention.launches == before + 1
    ref = ops.temporal_rpe_attention_plain(*args)
    assert (out - ref).abs().max().item() <= _tol(torch.float32, ref)
    q = torch.randn(1, 1, 1, 8, 136, generator=cuda, device="cuda")
    _check_spatial(q * 136 ** -0.5, q, q, "fma")
    n = ops.temporal_max_frames()  # the kernel's shared memory is full
    assert n >= 1024
    most = _temporal(cuda, 1, 1, n, 2, 3, torch.float32, 100)
    ref = ops.temporal_rpe_attention_plain(*most)
    assert (ops.temporal_rpe_attention(*most) - ref).abs().max().item() <= _tol(torch.float32, ref)
    big = _temporal(cuda, 1, 1, n + 1, 1, 1, torch.float32, 0)
    with pytest.raises(ValueError):
        ops.temporal_rpe_attention(*big)
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


def _skipconv_inputs(gen, N, c1, c2, F, H, W, dtype):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    K = c1 + c2
    return (rnd(N, c1, H, W), rnd(N, c2, H, W), rnd(F, K, scale=K ** -0.5), rnd(F, scale=0.1),
            rnd(N, F, H, W))


def _skipconv_tols(dtype, y, s1, s2):
    """f32 (TF32 off): accumulation order only. bf16: y in bf16 ulps of its
    scale; the statistics come from the same f32 values in another order."""
    f32 = dtype == torch.float32
    ys = y.float().abs().max().item()
    return ((1e-5 if f32 else 2e-2) * ys, (1e-4 if f32 else 2e-3) * s1.abs().max().item(),
            (1e-4 if f32 else 2e-3) * s2.abs().max().item())


def _skipconv_plan(N, c1, c2, F, H, W, dtype):
    return skipconv.plan(N, c1, c2, F, H * W, dtype, sms=skipconv._sm_count(0))


def _check_skipconv(args, route):
    """One launch on ``route`` (the kernel's counters), within _skipconv_tols
    of the plain version."""
    x1, _, _, _, resid = args
    N, F, dtype = x1.shape[0], resid.shape[1], x1.dtype
    before = skipconv.skip_conv_stats.launches
    by_route = dict(skipconv.skip_conv_stats.launches_by_route)
    y, s1, s2 = skipconv.skip_conv_stats(*args)
    ry, r1, r2 = skipconv.skip_conv_stats_plain(*args)
    torch.cuda.synchronize()
    assert skipconv.skip_conv_stats.launches == before + 1
    assert skipconv.skip_conv_stats.launches_by_route[route] == by_route[route] + 1
    assert y.dtype == dtype and y.shape == ry.shape and s1.shape == (N, F) == s2.shape
    ty, t1, t2 = _skipconv_tols(dtype, ry, r1, r2)
    assert (y.float() - ry.float()).abs().max().item() <= ty
    assert (s1 - r1).abs().max().item() <= t1
    assert (s2 - r2).abs().max().item() <= t2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,c1,c2,F,H,W", [
    (3, 40, 24, 72, 8, 8),      # c1 != c2, F not a multiple of the channel tile, P = 64
    (2, 64, 72, 136, 6, 12),    # c2 % 16 != 0: the generic route in bf16 too
    (2, 17, 5, 9, 5, 7),        # odd widths (element-wise path), one ragged pixel tile
    (1, 96, 130, 200, 13, 11),  # K past several 32-deep slices, ragged F and P
    (40, 512, 384, 512, 8, 8),  # flagship ds 16, block 1
    (4, 128, 128, 128, 64, 64),  # flagship ds 2, block 1 (4 of the 40 frames)
    (5, 128, 128, 128, 4, 4),    # latent middle level: 16 pixels
    (5, 128, 64, 64, 32, 32),    # latent ds 1, block 0
])
def test_skip_conv_kernel_matches_plain(cuda, dtype, N, c1, c2, F, H, W):
    args = _skipconv_inputs(cuda, N, c1, c2, F, H, W, dtype)
    _check_skipconv(args, _skipconv_plan(N, c1, c2, F, H, W, dtype).route)


# The bulk route's edges; each case names the plan it must get (w resident,
# BN). K % 16 == 0, P % 8 == 0 throughout.
BULK_CASES = {
    "k-slice-straddles-c1": ((2, 80, 48, 96, 16, 16), (True, 128)),
    "k-not-multiple-of-64": ((2, 48, 32, 64, 8, 16), (True, 128)),
    "k-tail-streaming": ((2, 336, 208, 160, 8, 8), (False, 64)),
    "p-tail": ((3, 64, 64, 128, 10, 20), (True, 128)),
    "p-tail-below-128": ((2, 32, 32, 64, 9, 8), (True, 64)),
    "f-tail-resident": ((2, 64, 64, 72, 16, 16), (True, 128)),
    "f-tail-streaming": ((2, 128, 128, 200, 16, 16), (False, 128)),
    "more-tiles-than-ctas": ((8, 128, 128, 128, 64, 64), (True, 128)),
    "streaming-many-tiles": ((12, 256, 256, 256, 32, 32), (False, 128)),
    "ds1-n4": ((4, 128, 128, 128, 128, 128), (True, 128)),
    "ds16-flagship": ((40, 512, 512, 512, 8, 8), (False, 64)),
    # The latent config's 6 distinct up-path shapes (B·K = 5 frames).
    "latent-ds8": ((5, 128, 128, 128, 4, 4), (True, 64)),
    "latent-ds4": ((5, 128, 128, 128, 8, 8), (True, 64)),
    "latent-ds2": ((5, 128, 128, 128, 16, 16), (True, 128)),
    "latent-ds2-c2-64": ((5, 128, 64, 128, 16, 16), (True, 128)),
    "latent-ds1-f-64": ((5, 128, 64, 64, 32, 32), (True, 128)),
    "latent-ds1-k-128": ((5, 64, 64, 64, 32, 32), (True, 128)),
}


@pytest.mark.parametrize("case", list(BULK_CASES))
def test_skip_conv_bulk_route_matches_plain(cuda, case):
    shape, (w_resident, bn) = BULK_CASES[case]
    p = _skipconv_plan(*shape, torch.bfloat16)
    assert (p.route, p.w_resident, p.bn) == ("bulk", w_resident, bn)
    if case.startswith("more-tiles"):
        N, _, _, F, H, W = shape
        assert N * p.p_tiles * -(-F // p.bm) > p.grid
    _check_skipconv(_skipconv_inputs(cuda, *shape, torch.bfloat16), "bulk")


def test_skip_conv_unaligned_view_takes_the_generic_route(cuda):
    """bf16 views one element past a 16-byte boundary: same function, generic route."""
    N, c, F, H, W = 2, 32, 64, 8, 8
    n = N * c * H * W
    buf = torch.randn(2, n + 1, generator=cuda, device="cuda").to(torch.bfloat16)
    x1, x2 = (row[1:].view(N, c, H, W) for row in buf)
    assert x1.data_ptr() % 16
    _, _, w, b, r = _skipconv_inputs(cuda, N, c, c, F, H, W, torch.bfloat16)
    _check_skipconv((x1, x2, w, b, r), "generic")


def test_skip_conv_plan_matches_the_library(cuda):
    """The Python plan is the C library's own, which the launch checks."""
    import chip_smoke

    sms = skipconv._sm_count(0)
    sizes = [(40, c1, c2, F, S * S) for _, c1, c2, F, S in chip_smoke.SKIP_SHAPES]
    sizes += [(5, c1, c2, F, S * S) for _, c1, c2, F, S in chip_smoke.LATENT_SKIP_SHAPES]
    sizes += [(N, c1, c2, F, H * W) for (N, c1, c2, F, H, W), _ in BULK_CASES.values()]
    sizes += [(2, 17, 5, 9, 35), (3, 32, 32, 64, 66), (1, 16, 16, 8, 64)]
    for size in sizes:
        for dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                for n_sms in (sms, 4):
                    kw = dict(aligned=aligned, sms=n_sms)
                    assert skipconv.plan(*size, dtype, **kw) == \
                        skipconv.library_plan(*size, dtype, **kw), (size, dtype, kw)


def test_skip_conv_refuses_another_plan(cuda):
    """The C function checks the plan it is given against its own."""
    import ctypes

    from lfvdm_tpu_torch.ops import _build

    x1, x2, w, b, r = _skipconv_inputs(cuda, 2, 32, 32, 64, 8, 8, torch.bfloat16)
    p = _skipconv_plan(2, 32, 32, 64, 8, 8, torch.bfloat16)
    wrong = p._replace(stages=p.stages - 1)
    y = torch.empty_like(r)
    part = torch.empty(2 * 2 * p.p_tiles * 64, device="cuda")
    s1, s2 = torch.empty(2, 64, device="cuda"), torch.empty(2, 64, device="cuda")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("skip_conv_stats", "lfvdm_skip_conv_stats",
                         [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P, P])
    for plan, want in ((wrong, 1), (p, 0)):  # cudaErrorInvalidValue, cudaSuccess
        rc = fn(1, x1.data_ptr(), x2.data_ptr(), w.data_ptr(), b.data_ptr(), r.data_ptr(),
                y.data_ptr(), part.data_ptr(), s1.data_ptr(), s2.data_ptr(), 2, 32, 32, 64, 64,
                (ctypes.c_int * 8)(*plan.fields()), torch.cuda.current_stream().cuda_stream)
        assert rc == want
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode,shape", [
    ("bulk-resident-bn128", (4, 64, 64, 64, 32, 32)),
    ("bulk-streaming-bn128", (2, 256, 256, 256, 32, 32)),
    ("bulk-streaming-bn64", (40, 512, 384, 512, 8, 8)),
    ("bulk-resident-bn64", (4, 64, 64, 64, 8, 8)),
    ("generic-bf16", (2, 64, 72, 136, 6, 12)),
])
def test_skip_conv_statistics_are_deterministic(cuda, mode, shape):
    """No atomics, a fixed tile order and fixed sums: repeated launches give
    bitwise-equal y, s1 and s2 on every route and mode."""
    p = _skipconv_plan(*shape, torch.bfloat16)
    if mode == "generic-bf16":
        assert p.route == "generic"
    else:
        assert (p.route, p.w_resident, f"bn{p.bn}") == \
            ("bulk", "resident" in mode, mode.split("-")[-1])
    args = _skipconv_inputs(cuda, *shape, torch.bfloat16)
    first = skipconv.skip_conv_stats(*args)
    for _ in range(3):
        again = skipconv.skip_conv_stats(*args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_skip_conv_backward_matches_plain(cuda):
    """The autograd backward (JAX's VJP in plain PyTorch) against autograd
    through the plain version, with cotangents on y, s1 and s2."""
    args = [a.requires_grad_() for a in _skipconv_inputs(cuda, 2, 24, 40, 36, 9, 10,
                                                          torch.float32)]
    gy = torch.randn(args[4].shape, generator=cuda, device="cuda")
    g1 = torch.randn(2, 36, generator=cuda, device="cuda")
    g2 = torch.randn(2, 36, generator=cuda, device="cuda") * 0.01
    got = torch.autograd.grad(skipconv.skip_conv_stats(*args), args, (gy, g1, g2))
    want = torch.autograd.grad(skipconv.skip_conv_stats_plain(*args), args, (gy, g1, g2))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_skip_conv_bad_inputs_raise(cuda):
    x1, x2, w, b, r = _skipconv_inputs(cuda, 2, 8, 8, 8, 4, 4, torch.float32)
    with pytest.raises(TypeError):
        skipconv.skip_conv_stats(x1.half(), x2.half(), w.half(), b.half(), r.half())
    with pytest.raises(ValueError):
        skipconv.skip_conv_stats(x1, x2, w[:, :15], b, r)
