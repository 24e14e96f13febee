"""Port vs JAX package: the whole video U-Net at the tiny flagship config (f32, CPU).

Weights: the port's torch-default init with every parameter perturbed (so
the zero-initialised layers carry signal), carried into the JAX tree by the
JAX package's own ``convert_unet_state_dict``. The window has observed,
latent and padding frames, so the two-group mask is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.config import create_model_and_diffusion as j_create
from lfvdm_tpu.models.nn import GroupNorm32 as JGroupNorm32
from lfvdm_tpu.models.nn import channel_sums as j_channel_sums
from lfvdm_tpu.utils.torch_convert import convert_unet_state_dict
from lfvdm_tpu_torch.config import CHANNEL_MULT_BY_IMAGE_SIZE, create_model, flagship_config
from lfvdm_tpu_torch.config import create_model_and_diffusion as t_create
from lfvdm_tpu_torch.models.nn import GroupNorm32, channel_sums
from lfvdm_tpu_torch.models.unet import (FactorizedAttentionBlock, ResBlock, attention_blocks,
                                         fused_skip_blocks)
from lfvdm_tpu_torch.ops import attention as ops
from lfvdm_tpu_torch.utils.convert import unet_state_dict_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = flagship_config(tiny=True)
CHANNEL_MULT = CHANNEL_MULT_BY_IMAGE_SIZE[CFG["image_size"]]


def make_inputs(B=2, T=6, seed=0):
    rng = np.random.default_rng(seed)
    C, S = CFG["in_channels"], CFG["image_size"]
    x = rng.standard_normal((B, T, C, S, S)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (B, T, C, S, S)).astype(np.float32)
    t = np.array([137.5, 875.0], np.float32)[:B]
    fi = np.sort(rng.choice(60, (B, T), replace=True), axis=1).astype(np.int32)
    obs = np.zeros((B, T, 1, 1, 1), np.float32)
    obs[:, :2] = 1.0
    lat = np.zeros_like(obs)
    lat[:, 2:5] = 1.0  # the last frame is padding: obs = latent = 0
    return x, t, dict(x0=x0, frame_indices=fi, obs_mask=obs, latent_mask=lat)


def perturbed_port_model(use_rpe_net, seed=0):
    model, _ = t_create(dict(CFG, use_rpe_net=use_rpe_net), device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def jax_params_from(model):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return convert_unet_state_dict(sd, num_res_blocks=CFG["num_res_blocks"],
                                   channel_mult=CHANNEL_MULT,
                                   attention_resolutions=model.attention_resolutions)


def run_port(model, x, t, kw, **extra):
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tkw["frame_indices"] = tkw["frame_indices"].long()
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t), **tkw, **extra)


def run_jax(params, x, t, kw, use_rpe_net, return_attn_weights=False):
    jmodel, _ = j_create(dict(CFG, use_rpe_net=use_rpe_net))
    apply = jax.jit(jmodel.apply, static_argnames=("return_attn_weights",))
    return apply(params, jnp.asarray(x), jnp.asarray(t), return_attn_weights=return_attn_weights,
                 **{k: jnp.asarray(v) for k, v in kw.items()})


@pytest.fixture(scope="module", params=[True, False], ids=["rpe_net", "lookup_table"])
def pair(request):
    use_rpe_net = request.param
    model = perturbed_port_model(use_rpe_net)
    params = jax_params_from(model)
    x, t, kw = make_inputs()
    ref, _ = run_jax(params, x, t, kw, use_rpe_net)
    return use_rpe_net, model, params, (x, t, kw), np.asarray(ref)


def test_forward_matches_jax(pair):
    _, model, _, (x, t, kw), ref = pair
    ops.reset_launch_counts()
    out, attns = run_port(model, x, t, kw)
    assert attns is None and out.shape == x.shape and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert ops.launch_counts() == {"temporal_rpe_attention": 0, "spatial_attention": 0,
                                  "skip_conv_stats": 0}


def test_forward_with_per_frame_timesteps(pair):
    use_rpe_net, model, params, (x, t, kw), _ = pair
    t_bt = np.linspace(3.0, 990.0, x.shape[0] * x.shape[1]).reshape(x.shape[:2]).astype(np.float32)
    ref, _ = run_jax(params, x, t_bt, kw, use_rpe_net)
    out, _ = run_port(model, x, t_bt, kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plain_impl_equals_auto_on_cpu(pair):
    _, model, _, (x, t, kw), _ = pair
    auto, _ = run_port(model, x, t, kw)
    plain, _ = run_port(model, x, t, kw, impl="plain")
    torch.testing.assert_close(auto, plain, atol=0, rtol=0)


def test_attention_weights_match_jax(pair):
    use_rpe_net, model, params, (x, t, kw), _ = pair
    ref_out, ref_attns = run_jax(params, x, t, kw, use_rpe_net, return_attn_weights=True)
    out, attns = run_port(model, x, t, kw, return_attn_weights=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    for kind in ("temporal", "spatial"):
        assert len(attns[kind]) == len(ref_attns[kind]) == attention_blocks(model)
        for a, r in zip(attns[kind], ref_attns[kind]):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


def test_observed_frames_ignore_the_noisy_input(pair):
    _, model, _, (x, t, kw), _ = pair
    x2 = x.copy()
    x2[:, :2] += 5.0  # observed frames: the model reads x0 there
    a, _ = run_port(model, x, t, kw)
    b, _ = run_port(model, x2, t, kw)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_state_dict_round_trip_through_the_jax_converter():
    """JAX tree -> utils.convert -> the port's state_dict (loads strictly)
    -> lfvdm_tpu's convert_unet_state_dict -> the same JAX tree, exactly."""
    jmodel, _ = j_create(CFG)
    x, t, kw = make_inputs(T=3)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)

    port, _ = t_create(CFG, device="cpu")
    sd = unet_state_dict_from_jax(tree, num_res_blocks=CFG["num_res_blocks"],
                                  channel_mult=CHANNEL_MULT,
                                  attention_resolutions=port.attention_resolutions)
    port.load_state_dict(sd, strict=True)
    back = convert_unet_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                   num_res_blocks=CFG["num_res_blocks"],
                                   channel_mult=CHANNEL_MULT,
                                   attention_resolutions=port.attention_resolutions)
    flat_tree = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_tree]
    for (path, a), (_, b) in zip(flat_tree, flat_back):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(32, 2, 32, 1, attention_resolutions="8", compute_dtype="float32")


def test_flagship_model_has_seven_attention_blocks():
    model, _ = t_create(dict(flagship_config(), num_channels=8), device="cpu")
    assert attention_blocks(model) == 7
    assert fused_skip_blocks(model) == 10


# ---------------------------------------------------------------------------
# The up path: per-part GroupNorm sums and the fused skip projection
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fused_pair():
    """The rpe_net model and JAX's output with its fused skip projection on
    (LFVDM_PALLAS_SKIPCONV=xla: _FusedSkipConv through _fwd_xla on the CPU)."""
    model = perturbed_port_model(True, seed=3)
    params = jax_params_from(model)
    x, t, kw = make_inputs(seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LFVDM_PALLAS_SKIPCONV", "xla")
        jmodel, _ = j_create(dict(CFG, use_rpe_net=True))
        # a fresh function, so that no trace made without the flag is reused
        ref, _ = jax.jit(lambda p, *a, **k: jmodel.apply(p, *a, **k))(
            params, jnp.asarray(x), jnp.asarray(t), **{k: jnp.asarray(v) for k, v in kw.items()})
    unfused, _ = run_jax(params, x, t, kw, True)
    return model, (x, t, kw), np.asarray(ref), np.asarray(unfused)


def test_fused_skip_conv_matches_jax_fused(fused_pair):
    model, (x, t, kw), ref, unfused = fused_pair
    assert model.fused_skip_conv and np.abs(ref).max() > 0.1
    # the flag changes JAX's output, so the comparison tells the two forms apart
    assert np.abs(ref - unfused).max() > 0
    ops.reset_launch_counts()
    out, _ = run_port(model, x, t, kw)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert ops.launch_counts()["skip_conv_stats"] == 0  # the CPU runs the plain version


def test_unfused_skip_conv_matches_jax_default(fused_pair):
    model, (x, t, kw), _, unfused = fused_pair
    model.fused_skip_conv = False
    try:
        out, _ = run_port(model, x, t, kw)
    finally:
        model.fused_skip_conv = True
    np.testing.assert_allclose(out.numpy(), unfused, **TOL)


def test_fused_config_key():
    cfg = dict(CFG, fused_skip_conv=False)
    model, _ = t_create(cfg, device="cpu")
    assert not model.fused_skip_conv and fused_skip_blocks(model) == 8
    remat, _ = t_create(dict(CFG, use_checkpoint=True), device="cpu")
    blocks = [m for m in remat.modules() if isinstance(m, (ResBlock, FactorizedAttentionBlock))]
    assert len(blocks) == 18 and all(b.use_checkpoint for b in blocks)
    assert not any(getattr(m, "use_checkpoint", False) for m in model.modules())


def test_channel_sums_and_precomputed_group_norm_match_jax():
    rng = np.random.default_rng(7)
    N, C, H, W = 3, 64, 5, 6
    x = (rng.standard_normal((N, C, H, W)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    g = rng.standard_normal((N, C, H, W)).astype(np.float32)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))

    js1, js2 = j_channel_sums(x_nhwc)
    ts1, ts2 = channel_sums(torch.from_numpy(x))
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=1e-5, rtol=1e-5)

    def j_norm(sums):
        out = JGroupNorm32().apply({"params": {"scale": scale, "bias": bias}}, x_nhwc,
                                   precomputed_sums=sums)
        return out, jnp.sum(out * jnp.asarray(g.transpose(0, 2, 3, 1)))

    jout, _ = j_norm((js1, js2))
    jg1, jg2 = jax.grad(lambda s: j_norm(s)[1])((js1, js2))

    gn = GroupNorm32(C)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    sums = (torch.tensor(np.asarray(js1)).requires_grad_(),
            torch.tensor(np.asarray(js2)).requires_grad_())
    out = gn(torch.from_numpy(x), precomputed_sums=sums)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-5)
    tg1, tg2 = torch.autograd.grad((out * torch.from_numpy(g)).sum(), sums)
    for got, ref in ((tg1, jg1), (tg2, jg2)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-4)
    # the same statistics as reading x itself, up to the variance formula
    torch.testing.assert_close(out, gn(torch.from_numpy(x)), atol=1e-5, rtol=1e-5)
