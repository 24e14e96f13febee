"""Port vs JAX package: NN primitives, RPENet and RPEAttention (f32, CPU).

Weights come from the JAX modules (initialised, then perturbed so that the
zero-initialised layers carry signal) and cross through
``lfvdm_tpu_torch.utils.convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.models import nn as jnn
from lfvdm_tpu.models import rpe as jrpe
from lfvdm_tpu_torch.models import nn as tnn
from lfvdm_tpu_torch.models import rpe as trpe
from lfvdm_tpu_torch.utils.convert import rpe_attention_state_dict_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.concatenate([np.arange(8), np.random.default_rng(0).uniform(0, 1000, 24)])
    t = t.astype(np.float32)
    ref = np.asarray(jnn.timestep_embedding(jnp.asarray(t), dim))
    out = tnn.timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert out.shape == (32, dim)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("C,groups", [(64, 32), (48, 16)])
@pytest.mark.parametrize("out_f32", [False, True])
def test_group_norm32(C, groups, out_f32):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 7, C)) * 2 + 0.5).astype(np.float32)  # channels last
    jmod = jnn.GroupNorm32(out_dtype=jnp.float32 if out_f32 else None)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))

    tmod = tnn.GroupNorm32(C, out_dtype=torch.float32 if out_f32 else None)
    assert tmod.num_groups == groups
    tmod.load_state_dict({"weight": torch.from_numpy(params["params"]["scale"]),
                          "bias": torch.from_numpy(params["params"]["bias"])})
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_group_norm32_bf16_statistics_in_f32():
    x = torch.randn(2, 48, 4, 4, dtype=torch.float64) * 3 + 100
    mod = tnn.GroupNorm32(48)
    out = mod(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.group_norm(x.to(torch.bfloat16).double(), 16)
    torch.testing.assert_close(out.double(), ref, atol=2e-2, rtol=2e-2)


def test_init_parameters_is_torch_default_and_seeded():
    lin = tnn.Linear(50, 20)
    zero = tnn.Linear(50, 20, zero=True)
    mod = torch.nn.ModuleList([lin, zero])
    tnn.init_parameters(mod, torch.Generator().manual_seed(0))
    bound = 50 ** -0.5
    assert lin.weight.abs().max() <= bound and lin.weight.abs().max() > 0.9 * bound
    assert lin.bias.abs().max() <= bound and (zero.weight == 0).all() and (zero.bias == 0).all()
    again = tnn.Linear(50, 20)
    tnn.init_parameters(again, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.weight, lin.weight, atol=0, rtol=0)


def _rpenet_state(params):
    p = params["params"]
    return {f"{name}.{k}": torch.from_numpy(np.ascontiguousarray(
        np.asarray(p[name]["kernel"]).T if k == "weight" else np.asarray(p[name]["bias"])))
        for name in ("embed_distances", "embed_diffusion_time", "out") for k in ("weight", "bias")}


def test_rpenet():
    rng = np.random.default_rng(3)
    B, T, C, H, E = 2, 6, 16, 4, 24
    temb = rng.standard_normal((B, T, E)).astype(np.float32)
    fi = np.sort(rng.integers(0, 40, (B, T)), axis=1)
    pd = (fi[:, :, None] - fi[:, None, :]).astype(np.int32)
    jmod = jrpe.RPENet(C, H)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(temb), jnp.asarray(pd)), 4)
    ref = np.asarray(jmod.apply(params, jnp.asarray(temb), jnp.asarray(pd)))
    tmod = trpe.RPENet(C, H, E)
    tmod.load_state_dict(_rpenet_state(params))
    with torch.no_grad():
        out = tmod(torch.from_numpy(temb), torch.from_numpy(pd).long()).numpy()
    assert out.shape == (B, T, T, H, C // H)
    np.testing.assert_allclose(out, ref, **TOL)


def _attention_case(kind, seed, B=2, D=6, T=5, C=16, H=2, E=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, T, C)).astype(np.float32)
    temb = rng.standard_normal((B, T, E)).astype(np.float32)
    fi = np.sort(rng.integers(0, 90, (B, T)), axis=1).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[0, -2:] = 0.0
    mask[1, 0] = 0.0
    if kind == "spatial":
        kw = dict(use_rpe_q=False, use_rpe_k=False, use_rpe_v=False)
        call = dict()
    else:
        kw = dict(use_rpe_net=(kind == "rpe_net"))
        call = dict(temb=temb, frame_indices=fi, attn_mask=mask)
    return x, kw, call


def _run_pair(kind, seed, return_attn, call_overrides=None):
    x, kw, call = _attention_case(kind, seed)
    call = {**call, **(call_overrides or {})}
    C = x.shape[-1]
    jmod = jrpe.RPEAttention(channels=C, num_heads=2, **kw)
    jcall = {k: (None if v is None else jnp.asarray(v)) for k, v in call.items()}
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), **jcall), seed + 1)
    ref_out, ref_attn = jmod.apply(params, jnp.asarray(x), return_attn=return_attn, **jcall)

    E = call["temb"].shape[-1] if "temb" in call and call["temb"] is not None else 0
    tmod = trpe.RPEAttention(C, 2, time_embed_dim=E, **kw)
    tmod.load_state_dict(rpe_attention_state_dict_from_jax(params))
    tcall = {k: (None if v is None else torch.from_numpy(np.asarray(v))) for k, v in call.items()}
    if tcall.get("frame_indices") is not None:
        tcall["frame_indices"] = tcall["frame_indices"].long()
    with torch.no_grad():
        out, attn = tmod(torch.from_numpy(x), return_attn=return_attn, **tcall)
    return (np.asarray(ref_out), None if ref_attn is None else np.asarray(ref_attn),
            out.numpy(), None if attn is None else attn.numpy())


@pytest.mark.parametrize("kind", ["rpe_net", "lookup_table", "spatial"])
@pytest.mark.parametrize("return_attn", [False, True])
def test_rpe_attention(kind, return_attn):
    """Without weights the port takes its kernel wrappers (plain versions on
    the CPU); with weights, the einsum path. Both equal the JAX module."""
    ref_out, ref_attn, out, attn = _run_pair(kind, 5, return_attn)
    np.testing.assert_allclose(out, ref_out, **TOL)
    if return_attn:
        np.testing.assert_allclose(attn, ref_attn, **TOL)
    else:
        assert attn is None and ref_attn is None


def test_rpe_attention_without_mask():
    ref_out, _, out, _ = _run_pair("rpe_net", 6, False, {"attn_mask": None})
    np.testing.assert_allclose(out, ref_out, **TOL)


def test_partial_rpe_takes_the_einsum_path():
    x, _, call = _attention_case("rpe_net", 7)
    kw = dict(use_rpe_net=True, use_rpe_v=False)
    C, E = x.shape[-1], call["temb"].shape[-1]
    jmod = jrpe.RPEAttention(channels=C, num_heads=2, **kw)
    jcall = {k: jnp.asarray(v) for k, v in call.items()}
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), **jcall), 8)
    ref, _ = jmod.apply(params, jnp.asarray(x), **jcall)
    tmod = trpe.RPEAttention(C, 2, time_embed_dim=E, **kw)
    tmod.load_state_dict(rpe_attention_state_dict_from_jax(params))
    tcall = {k: torch.from_numpy(v) for k, v in call.items()}
    tcall["frame_indices"] = tcall["frame_indices"].long()
    with torch.no_grad():
        out, _ = tmod(torch.from_numpy(x), **tcall)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("broken", [False, True])
def test_two_group_softmax(monkeypatch, broken):
    if broken:
        monkeypatch.setenv("LFVDM_BREAK_TWO_GROUP", "1")
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 3, 2, 6, 6)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [1, 0, 1, 0, 1, 0]], np.float32)
    ref = np.asarray(jrpe.two_group_softmax(jnp.asarray(logits), jnp.asarray(mask)))
    out = trpe.two_group_softmax(torch.from_numpy(logits), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_break_two_group_reaches_the_kernel_path(monkeypatch):
    """With LFVDM_BREAK_TWO_GROUP=1 the wrapper path ignores the mask too,
    as the JAX module's (einsum) default path does."""
    monkeypatch.setenv("LFVDM_BREAK_TWO_GROUP", "1")
    ref_out, _, out, _ = _run_pair("rpe_net", 10, False)
    np.testing.assert_allclose(out, ref_out, **TOL)
