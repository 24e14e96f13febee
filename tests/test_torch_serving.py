"""The port's serving module (``lfvdm_tpu_torch.serving``) and its kernel
operators, on the CPU (tiny config, f32, one torch thread).

An exported artifact (one reverse step under ``torch.export``, looped by
``load_window_sampler`` on the sampler's own buffers) is held bitwise to the
live ``make_window_sampler`` with the same seed (the same code runs both
ways) and to the eager loop on the caller's tensors (``graphs=False``); a
call with other params, or with its params changed in place, samples with
those, and two threads sharing one sampler each get their own params'
window. Its DDIM window with eta 0 is held to the JAX package's
``serving.make_window_sampler`` on the same weights,
started from JAX's own initial noise, at ``test_torch_sampling``'s
tolerance. A fresh interpreter that cannot import JAX, flax, msgpack, the
JAX package or the port's model, config, diffusion and sampling modules
loads and serves the artifact. ``torch.library.opcheck`` checks each of the
three operators' schema, fake implementation and autograd registration.
"""

import io
import json
import subprocess
import sys
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu import serving as jserving
from lfvdm_tpu_torch import serving
from lfvdm_tpu_torch.ops import attention as ops
from test_torch_sampling import B, CFG, K, assert_close_conditioned, build_models, diffusions

ROOT = Path(__file__).resolve().parents[1]
RESPACING = {"ddim": "ddim4", "ancestral": ""}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (it shares the CPU with the
    other test workers). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def artifacts(models):
    """{sampler: (artifact bytes, its loaded sampler, the port's diffusion)}
    for DDIM (ddim4, eta 0) and the ancestral sampler (8 steps), exported on
    the CPU."""
    model = models[0]
    out = {}
    for kind, respacing in RESPACING.items():
        _, td = diffusions(respacing)
        blob = serving.export_window_sampler(
            model, td, dict(model.state_dict()), batch_size=B, max_frames=K,
            in_channels=CFG["in_channels"], image_size=CFG["image_size"],
            use_ddim=kind == "ddim", device="cpu")
        out[kind] = (blob, serving.load_window_sampler(blob), td)
    return out


def window(seed=0):
    rng = np.random.default_rng(seed)
    C, S = CFG["in_channels"], CFG["image_size"]
    obs = np.zeros((B, K, 1, 1, 1), np.float32)
    obs[:, :2] = 1.0
    return dict(x0=rng.uniform(-1, 1, (B, K, C, S, S)).astype(np.float32),
                frame_indices=np.array([[0, 1, 4, 5, 6]], np.int64), obs_mask=obs,
                latent_mask=1.0 - obs)


def torch_window(seed=0):
    return [torch.from_numpy(v) for v in window(seed).values()]


@pytest.mark.parametrize("kind", list(RESPACING))
def test_served_window_equals_the_live_sampler(models, artifacts, kind):
    model = models[0]
    _, run, td = artifacts[kind]
    assert run.meta["sampler"] == kind and run.meta["num_timesteps"] == td.num_timesteps
    params = dict(model.state_dict())
    live = serving.make_window_sampler(model, td, use_ddim=kind == "ddim")
    got = run(params, *torch_window(1), 7)
    want = live(params, *torch_window(1), 7)
    assert got.shape == (B, K, CFG["in_channels"], CFG["image_size"], CFG["image_size"])
    assert torch.equal(got, want)
    # The loop on the sampler's own buffers against the eager loop on the
    # caller's tensors, and a second call from the same seed: bitwise.
    eager = serving.ServedWindow(run.program, run.meta, graphs=False)
    assert torch.equal(got, eager(params, *torch_window(1), 7))
    again = run(params, *torch_window(1), 7)
    assert torch.equal(again, got) and again is not run.buffers["x"]
    assert not torch.equal(got, run(params, *torch_window(1), 8))  # the seed reaches the noise


def test_a_call_samples_with_its_own_params(models, artifacts):
    """``params`` stay an argument: a call with other tensors, and one with
    the same tensors changed in place, each give a fresh sampler's window
    for those values (bitwise), not the first call's."""
    model = models[0]
    blob, run, td = artifacts["ancestral"]
    params = {k: v.clone() for k, v in model.state_dict().items()}
    first = run(params, *torch_window(10), 3)
    other = {k: v * 1.01 if v.is_floating_point() else v for k, v in params.items()}
    got = run(other, *torch_window(10), 3)
    fresh = serving.ServedWindow(run.program, run.meta)
    assert torch.equal(got, fresh(other, *torch_window(10), 3))
    assert not torch.equal(got, first)
    for v in params.values():  # the first call's tensors, changed in place
        if v.is_floating_point():
            v.mul_(0.99)
    got = run(params, *torch_window(10), 3)
    assert torch.equal(got, serving.ServedWindow(run.program, run.meta)(
        params, *torch_window(10), 3))
    assert not torch.equal(got, first)


def test_threads_sharing_a_sampler_each_get_their_params_window(models, artifacts):
    """Two threads call one loaded sampler at once, each with its own params:
    the calls take turns on its buffers, so each returns the eager window
    for its own params (bitwise)."""
    model = models[0]
    _, run, _ = artifacts["ancestral"]
    params = dict(model.state_dict())
    other = {k: v * 1.02 if v.is_floating_point() else v for k, v in params.items()}
    eager = serving.ServedWindow(run.program, run.meta, graphs=False)
    want = [eager(p, *torch_window(11), 5) for p in (params, other)]
    assert not torch.equal(*want)
    start = threading.Barrier(2)

    def calls(p):
        start.wait()
        return [run(p, *torch_window(11), 5) for _ in range(3)]

    with ThreadPoolExecutor(2) as pool:
        got = [f.result() for f in [pool.submit(calls, p) for p in (params, other)]]
    for outs, ref in zip(got, want):
        assert all(torch.equal(out, ref) for out in outs)


def test_served_ddim_window_matches_jax(models, artifacts):
    """JAX's ``make_window_sampler`` (DDIM, eta 0) on the same weights, and
    the served window started from JAX's initial noise:
    ``jax.random.normal(jax.random.split(key)[1], shape)``."""
    model, jmodel, jparams = models
    _, run, td = artifacts["ddim"]
    jd, _ = diffusions(RESPACING["ddim"])
    kw = window(2)
    key = jax.random.PRNGKey(3)
    shape = kw["x0"].shape
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], shape))
    fn = jserving.make_window_sampler(jmodel, jd, use_ddim=True, eta=0.0)
    ref = fn(jparams, *(jnp.asarray(v) for v in kw.values()), key)
    got = run(dict(model.state_dict()), *torch_window(2), 0,
              noise=torch.from_numpy(noise.copy()))
    assert_close_conditioned(got.numpy(), np.asarray(ref),
                             td.table("sqrt_recip_alphas_cumprod").max())


def test_ancestral_step_noise_is_injectable(models, artifacts):
    """``step_noise`` replaces each step's draw, as in ``p_sample_loop``."""
    model = models[0]
    _, run, td = artifacts["ancestral"]
    rng = np.random.default_rng(4)
    shape = window()["x0"].shape
    noise = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    steps = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for _ in range(td.num_timesteps)]
    params = dict(model.state_dict())
    got = run(params, *torch_window(3), 0, noise=noise, step_noise=steps)
    want = serving.make_window_sampler(model, td)(params, *torch_window(3), 0, noise=noise,
                                                   step_noise=steps)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_artifact_holds_no_weights(models, artifacts):
    """The graph's constants are the schedule tables (one value per step) and
    nothing else; the metadata names the window and the params."""
    blob, run, td = artifacts["ddim"]
    program = run.program
    assert not program.state_dict
    assert program.constants
    assert all(c.numel() == td.num_timesteps for c in program.constants.values())
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    for name in ("spatial_attention", "temporal_rpe_attention", "skip_conv_stats"):
        assert f"lfvdm.{name}.default" in targets
    meta = serving.artifact_meta(blob)
    assert meta["shape"] == [B, K, CFG["in_channels"], CFG["image_size"], CFG["image_size"]]
    assert meta["device"] == "cpu" and meta["eta"] == 0.0 and not meta["draws_step_noise"]
    assert [p[0] for p in meta["params"]] == list(models[0].state_dict())


SERVE_CHILD = """
import importlib.abc, sys
BLOCKED = ("jax", "flax", "msgpack", "lfvdm_tpu", "lfvdm_tpu_torch.models",
           "lfvdm_tpu_torch.config", "lfvdm_tpu_torch.diffusion", "lfvdm_tpu_torch.sampling")
def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
for name in list(sys.modules):
    if blocked(name):
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(1)
from lfvdm_tpu_torch import serving
d = sys.argv[1]
params = serving.load_params_npz(d + "/params.npz")
run = serving.load_window_sampler(open(d + "/sampler.pt2", "rb").read())
w = np.load(d + "/window.npz")
out = run(params, *(torch.from_numpy(w[k]) for k in ("x0", "frame_indices", "obs_mask",
                                                      "latent_mask")), 11)
np.save(d + "/served.npy", out.numpy())
bad = sorted(m for m in sys.modules if blocked(m))
assert not bad, bad
print("ok")
"""


def test_a_serving_process_needs_no_model_code(models, artifacts, tmp_path):
    model = models[0]
    blob, _, td = artifacts["ancestral"]
    params = dict(model.state_dict())
    (tmp_path / "sampler.pt2").write_bytes(blob)
    serving.save_params_npz(params, tmp_path / "params.npz")
    np.savez(tmp_path / "window.npz", **window(5))
    child = subprocess.run([sys.executable, "-c", SERVE_CHILD, str(tmp_path)], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    assert child.returncode == 0 and child.stdout.strip() == "ok", child.stderr
    want = serving.make_window_sampler(model, td)(params, *torch_window(5), 11)
    np.testing.assert_allclose(np.load(tmp_path / "served.npy"), want.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_params_npz_round_trip(tmp_path):
    """Template-free and templated restores; a bf16 leaf comes back bf16,
    bit for bit; a template casts to its dtypes."""
    g = torch.Generator().manual_seed(0)
    params = {"a.weight": torch.randn(3, 4, generator=g),
              "block": {"scale": torch.randn(5, generator=g).to(torch.bfloat16),
                        "steps": torch.arange(4, dtype=torch.int32)}}
    path = tmp_path / "p.npz"
    serving.save_params_npz(params, path)
    got = serving.load_params_npz(path)
    assert set(got) == {"a.weight", "block"} and set(got["block"]) == {"scale", "steps"}
    assert torch.equal(got["a.weight"], params["a.weight"])
    assert got["block"]["scale"].dtype == torch.bfloat16
    assert torch.equal(got["block"]["scale"].view(torch.int16),
                       params["block"]["scale"].view(torch.int16))
    assert torch.equal(got["block"]["steps"], params["block"]["steps"])
    like = {"a.weight": torch.zeros(3, 4, dtype=torch.bfloat16),
            "block": {"scale": torch.zeros(5), "steps": torch.zeros(4, dtype=torch.int64)}}
    cast = serving.load_params_npz(path, like=like)
    assert cast["a.weight"].dtype == torch.bfloat16
    assert torch.equal(cast["a.weight"], params["a.weight"].to(torch.bfloat16))
    assert cast["block"]["scale"].dtype == torch.float32
    assert torch.equal(cast["block"]["scale"], params["block"]["scale"].float())
    assert cast["block"]["steps"].dtype == torch.int64


@pytest.mark.parametrize("bad", [{"a/b": torch.zeros(1)}, {1: torch.zeros(1)},
                                 {"a": {}}, {serving.BF16_KEYS: torch.zeros(1)}])
def test_params_npz_refuses_keys_it_cannot_rebuild(tmp_path, bad):
    with pytest.raises(ValueError, match="save_params_npz"):
        serving.save_params_npz(bad, tmp_path / "p.npz")


def test_wrong_window_bad_key_and_missing_card_raise(models, artifacts):
    model = models[0]
    blob, run, _ = artifacts["ddim"]
    params = dict(model.state_dict())
    x0, fi, obs, lat = torch_window(6)
    with pytest.raises(ValueError, match=r"exported for the ddim sampler at \(1, 5, 2, 32, 32\)"):
        run(params, x0[:, :4], fi[:, :4], obs[:, :4], lat[:, :4], 0)
    with pytest.raises(ValueError, match="on cpu"):
        run(params, x0.to("meta"), fi, obs, lat, 0)
    renamed = {("bad.key" if k == "out.2.bias" else k): v for k, v in params.items()}
    with pytest.raises(KeyError, match="missing \\['out.2.bias'\\], unexpected \\['bad.key'\\]"):
        run(renamed, x0, fi, obs, lat, 0)
    # The same artifact marked as exported for a card: refused where there is none.
    src, dst = io.BytesIO(blob), io.BytesIO()
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item)
            if item.filename.endswith("extra/" + serving.META):
                data = json.dumps(dict(json.loads(data), device="cuda:0")).encode()
            zout.writestr(item, data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="exported for cuda:0"):
            serving.load_window_sampler(dst.getvalue())
    with pytest.raises(ValueError, match="not a window-sampler artifact"):
        serving.load_window_sampler(b"PK\x05\x06" + b"\0" * 18)


# ---- the kernels as operators ----


def _op_inputs(name, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()

    if name == "spatial_attention":
        return tuple(r(1, 3, 2, 5, 4) for _ in range(3))
    if name == "temporal_rpe_attention":
        B, H, T, F, D = 1, 2, 3, 4, 5
        return (r(B, H, T, F, D), r(B, H, T, F, D), r(B, H, T, F, D), r(B, H, T, T, F),
                r(B, H, T, T, F), r(B, H, T, F, T), torch.tensor([[1.0, 1.0, 0.0]]))
    if name == "group_norm_silu":
        return (r(2, 6, 3, 4), r(6), r(6), r(2, 6), r(2, 6), None, None, 3, 1e-5, None)
    return (r(2, 3, 4, 4), r(2, 5, 4, 4), r(6, 8), r(6), r(2, 6, 4, 4))


@pytest.mark.parametrize("name", ["spatial_attention", "temporal_rpe_attention",
                                  "skip_conv_stats", "group_norm_silu"])
def test_operator_passes_opcheck(name):
    """Schema, fake implementation and autograd registration."""
    op = getattr(torch.ops.lfvdm, name).default
    result = torch.library.opcheck(op, _op_inputs(name), test_utils=(
        "test_schema", "test_faketensor", "test_autograd_registration"))
    assert set(result.values()) == {"SUCCESS"}, result


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 1, 1, 4, 4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.spatial_attention(q, q, q)
