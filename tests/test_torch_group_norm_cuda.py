"""The fused GroupNorm, scale-shift and SiLU kernel (``ops/groupnorm.py``,
``csrc/group_norm_silu.cu``) on the card.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine). On a machine with a card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_norm_cuda.py

- At every distinct norm site of one flagship and one latent U-Net forward
  (the shapes recorded from a forward, at N = 160 and 40 frames): the kernel
  against the chain computed exactly in f32, and against the modules' route.
  Tolerance, bf16 output: each element within 2^-8 of its f32 value (one
  rounding to bf16, half an ulp, plus a little for f32 summation order) and
  1e-5 of the site's largest value; and its RMS error at most the modules'
  route's, which rounds two to four times (the norm, then the scale, the
  shift and SiLU each in bf16) where the kernel rounds once. f32 output (the
  head, f32 models): 2e-5 of each value and of the largest (summation order,
  ``__expf``).
- Edge shapes: odd H·W (the element-wise route), groups of a gcd, a slab
  split into a cluster of 8 blocks, slabs past what the registers hold (read
  again), f32 input.
- The route: the kernel only on the card, without gradients, and not under
  ``impl="plain"``.
- A flagship-width DDIM step captured by ``WindowProgram`` under no grad:
  its replay launches the kernel 35 times a model call (34 ResBlock norms
  and the head), and its update is the eager plain step's within the
  forward's kernel-versus-plain limit.
"""

import pytest
import torch

from lfvdm_tpu_torch.config import create_model_and_diffusion, flagship_config, latent_config
from lfvdm_tpu_torch.models.nn import GroupNorm32, channel_sums
from lfvdm_tpu_torch.ops import groupnorm

pytestmark = pytest.mark.cuda

N_FRAMES = {"flagship": 160, "latent": 40}  # B·K of the benchmark's windows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _model(name, respacing="ddim2"):
    cfg = dict(flagship_config() if name == "flagship" else latent_config(),
               timestep_respacing=respacing)
    model, diffusion = create_model_and_diffusion(cfg, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # the zero layers at a tenth of the default bound
        for m in model.modules():
            if getattr(m, "zero", False):
                b = 0.1 / m.weight[0].numel() ** 0.5
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-b, b, generator=gen))
    return cfg, model, diffusion


def _window(cfg, B, K, gen):
    C, S = cfg["in_channels"], cfg["image_size"]
    obs = torch.zeros(B, K, 1, 1, 1, device="cuda")
    obs[:, :K // 2] = 1
    x = torch.randn(B, K, C, S, S, generator=gen, device="cuda")
    return x, dict(x0=torch.rand(B, K, C, S, S, generator=gen, device="cuda") * 2 - 1,
                   frame_indices=torch.arange(K, device="cuda")[None].expand(B, K).contiguous(),
                   obs_mask=obs, latent_mask=1 - obs)


def _sites(name, gen):
    """The distinct (C, H, W, dtype, sums, scale-shift, out dtype) of one
    forward's ``GroupNorm32.silu`` calls, with the number of calls."""
    cfg, model, _ = _model(name)
    seen = {}
    real = GroupNorm32.silu

    def spy(self, h, *, sums=None, scale=None, shift=None, fused=True):
        if fused:
            key = (h.shape[1], h.shape[2], h.shape[3], h.dtype, sums is not None,
                   scale is not None, self.out_dtype, self.num_groups)
            seen[key] = seen.get(key, 0) + 1
        return real(self, h, sums=sums, scale=scale, shift=shift, fused=fused)

    x, kw = _window(cfg, 1, 2, gen)
    mp = pytest.MonkeyPatch()
    mp.setattr(GroupNorm32, "silu", spy)
    try:
        with torch.no_grad():
            model(x, torch.tensor([300.0], device="cuda"), **kw)
    finally:
        mp.undo()
    return seen


def _inputs(C, H, W, dtype, sums, scale_shift, out_dtype, N, gen):
    x = (0.5 + 1.3 * torch.randn(N, C, H, W, generator=gen, device="cuda")).to(dtype)
    w = 1 + 0.3 * torch.randn(C, generator=gen, device="cuda")
    b = 0.2 * torch.randn(C, generator=gen, device="cuda")
    emb = (0.3 * torch.randn(N, 2 * C, 1, 1, generator=gen, device="cuda")).to(out_dtype or dtype)
    scale, shift = emb.chunk(2, dim=1) if scale_shift else (None, None)
    return x, w, b, scale, shift, channel_sums(x) if sums else None


def _check(x, w, b, scale, shift, s, G, out_dtype):
    kw = dict(scale=scale, shift=shift, sums=s, groups=G, eps=1e-5, out_dtype=out_dtype)
    before = groupnorm.group_norm_silu.launches
    got = groupnorm.group_norm_silu(x, w, b, **kw)
    again = groupnorm.group_norm_silu(x, w, b, **kw)
    torch.cuda.synchronize()
    assert groupnorm.group_norm_silu.launches == before + 2
    assert torch.equal(got, again)  # no atomics
    s1, s2 = s if s is not None else (None, None)
    plain = groupnorm.group_norm_silu_plain(x, w, b, scale, shift, s1, s2, G, 1e-5, out_dtype)
    f32 = None if scale is None else (scale.float(), shift.float())
    exact = groupnorm.group_norm_silu_plain(x.float(), w, b, *(f32 or (None, None)), s1, s2, G,
                                            1e-5, torch.float32)
    assert got.dtype == plain.dtype and got.shape == x.shape
    err = (got.float() - exact).abs()
    top = exact.abs().max().item()
    if got.dtype == torch.bfloat16:
        assert (err <= 2.0 ** -8 * exact.abs() + 1e-5 * top).all(), err.max().item()
        rms = err.square().mean().sqrt().item()
        assert rms <= (plain.float() - exact).square().mean().sqrt().item()
    else:
        assert (err <= 2e-5 * exact.abs() + 2e-5 * top).all(), err.max().item()
    return err.max().item()


@pytest.mark.parametrize("name", ["flagship", "latent"])
def test_kernel_at_every_norm_site(cuda, name):
    sites = _sites(name, cuda)
    assert sum(sites.values()) == {"flagship": 35, "latent": 29}[name]
    for (C, H, W, dtype, sums, ss, out_dtype, G), _ in sorted(sites.items(), key=str):
        args = _inputs(C, H, W, dtype, sums, ss, out_dtype, N_FRAMES[name], cuda)
        _check(*args, G, out_dtype)


@pytest.mark.parametrize("C,H,W,G,dtype,sums,ss,out_dtype", [
    (64, 5, 7, 32, torch.bfloat16, False, True, None),     # odd H·W: element-wise route
    (48, 6, 6, 16, torch.bfloat16, True, True, None),      # gcd groups, sums
    (256, 128, 128, 32, torch.bfloat16, False, True, None),  # 131,072 a slab: 8 parts
    (512, 128, 128, 32, torch.bfloat16, False, True, None),  # 262,144: read again
    (256, 128, 128, 32, torch.float32, False, True, None),   # f32 past the registers
    (256, 64, 64, 32, torch.float32, True, True, None),      # 4 streamed parts
    (96, 16, 16, 32, torch.float32, True, False, None),
    (128, 32, 32, 32, torch.bfloat16, False, False, torch.float32),
    (3, 9, 9, 1, torch.bfloat16, False, False, torch.float32),  # one group of 3
])
def test_kernel_at_edge_shapes(cuda, C, H, W, G, dtype, sums, ss, out_dtype):
    _check(*_inputs(C, H, W, dtype, sums, ss, out_dtype, 6, cuda), G, out_dtype)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 64, 4, 4, device="cuda")
    w = torch.ones(64, device="cuda")
    with pytest.raises(TypeError, match="narrow"):
        groupnorm.group_norm_silu(x, w, w, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale and shift"):
        groupnorm.group_norm_silu(x, w, w, scale=torch.zeros(2, 64, device="cuda",
                                                              dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="groups"):
        groupnorm.group_norm_silu(x, w, w, groups=5)


def test_route_takes_the_kernel_only_without_gradients(cuda):
    from lfvdm_tpu_torch.models import unet

    block = unet.ResBlock(64, 128, 64).cuda()
    x = torch.zeros(2, 64, 8, 8, device="cuda")
    with torch.no_grad():
        assert unet._fuses_norms("auto", x, None, block)
        assert not unet._fuses_norms("plain", x, None, block)
    assert not unet._fuses_norms("auto", x, None, block)  # the parameters take gradients
    block.requires_grad_(False)
    assert unet._fuses_norms("auto", x, None, block)
    assert not unet._fuses_norms("auto", x.requires_grad_(), None, block)


def test_captured_window_launches_35_per_call(cuda):
    from lfvdm_tpu_torch.diffusion.gaussian import step_timestep
    from lfvdm_tpu_torch.sampling.graphs import WindowProgram

    cfg, model, diffusion = _model("flagship")
    model.eval()
    x, kw = _window(cfg, 1, 8, cuda)
    program = WindowProgram(model, diffusion, kw, mode="ddim")
    with torch.no_grad():
        program.load(kw, x)
        program.run(0)  # warm-up and capture
        start = program.x.clone()
        program.load(kw, x)
        before = groupnorm.group_norm_silu.launches
        program.run(0)  # replay
        torch.cuda.synchronize()
        assert groupnorm.group_norm_silu.launches - before == 35
        assert torch.equal(program.x, start)

        def plain(xt, ts, **k):
            return model(xt, ts, impl="plain", **k)[0]

        t = step_timestep(diffusion.step_timesteps("cuda"), torch.zeros((), dtype=torch.int64,
                                                                          device="cuda"), 1)
        before = groupnorm.group_norm_silu.launches
        eager = diffusion.ddim_sample(plain, x.clone(), t, eta=0.0, model_kwargs=kw,
                                      clip_denoised=True)["sample"]
        assert groupnorm.group_norm_silu.launches == before
    change, want = program.x - x, eager - x
    rel = ((change - want).norm() / want.norm()).item()
    assert rel <= 5e-3, rel
