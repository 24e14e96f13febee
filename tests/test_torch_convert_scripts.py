"""The port's weight converters (``lfvdm_tpu_torch/scripts/convert_{svd_vae,
lpips,i3d}.py``) against the JAX package's (CPU, f32).

Each converter's ``main`` runs in process with ``--device cpu`` on the
seeded stand-in of its source library in ``tests/fixtures`` (a
diffusers-shaped SVD VAE, ``lpips.LPIPS`` with AlexNet, a TF1 I3D graph
behind ``hub.Module``), put in ``sys.modules`` under the library's name.
The files it writes must be the JAX scripts' files bit for bit (keys,
dtypes, shapes, values): the SVD pair against ``scripts/convert_svd_vae.py``'s
``convert`` and ``flatten``, the LPIPS file against the JAX script's own
``main`` (with its JAX check), the I3D file against ``tf_var_to_flax`` of
the fixture graph's variables. The mappings both ways are inverses bit for
bit; a missing library or card raises. The port's modules read the files
back to 1e-5 relative L2 of the fixtures (the converters' own checks hold
them to 1e-3, as the JAX scripts do).
"""

import importlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.evals.i3d import I3D
from lfvdm_tpu_torch.evals.lpips import LpipsEmbedderModule
from lfvdm_tpu_torch.models import vae as tvae
from lfvdm_tpu_torch.scripts import convert_i3d, convert_lpips, convert_svd_vae
from lfvdm_tpu_torch.utils import convert as conv
from test_torch_evals_i3d import tf_hub_variables
from test_torch_evals_resnet import one_torch_thread  # noqa: F401
from test_torch_vae import rel_l2, tiny_vae_pair

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
PORT = {"convert_svd_vae": convert_svd_vae, "convert_lpips": convert_lpips,
        "convert_i3d": convert_i3d}


def _import_from(directory, name):
    sys.path.insert(0, str(directory))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def _library(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


def _read(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def assert_same_arrays(got, want):
    """Key for key, dtype, shape and every bit."""
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k


svd_fixture = _import_from(FIXTURES, "torch_svd_vae_fixture")
lpips_fixture = _import_from(FIXTURES, "torch_lpips_fixture")
jax_convert_svd_vae = _import_from(ROOT / "scripts", "convert_svd_vae")
jax_convert_i3d = _import_from(ROOT / "scripts", "convert_i3d")


# ---------------------------------------------------------------------------
# SVD VAE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def svd_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("svd") / "svd_vae")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "diffusers", _library(
            "diffusers", AutoencoderKLTemporalDecoder=svd_fixture.AutoencoderKLTemporalDecoder))
        assert convert_svd_vae.main(["--out", prefix, "--device", "cpu"]) == prefix
    return prefix


def test_svd_vae_pair_is_the_jax_scripts(svd_prefix):
    source = svd_fixture.AutoencoderKLTemporalDecoder()
    sd = {k: v.numpy() for k, v in source.state_dict().items()}
    enc, dec = jax_convert_svd_vae.convert(sd)
    assert_same_arrays(_read(f"{svd_prefix}_encoder.npz"), jax_convert_svd_vae.flatten(enc))
    assert_same_arrays(_read(f"{svd_prefix}_decoder.npz"), jax_convert_svd_vae.flatten(dec))


def test_svd_vae_pair_reproduces_the_fixture(svd_prefix):
    """``load_svd_vae`` on the pair: the fixture's encode means and its
    per-frame decode (the consumer round trip of the JAX fixture runner)."""
    source = svd_fixture.AutoencoderKLTemporalDecoder().eval()
    vae = tvae.load_svd_vae(svd_prefix, device="cpu")
    assert vae.pretrained
    video = np.random.default_rng(1).uniform(-1, 1, (1, 2, 3, 64, 64)).astype(np.float32)
    z = vae.encode_video(video)
    assert z.shape == (1, 2, 4, 8, 8)
    with torch.no_grad():
        want_mean = source.quant_conv(source.encoder(torch.from_numpy(video[0])))[:, :4]
        want_img = source.decoder(z[0], num_frames=1)
    assert rel_l2(z[0], want_mean) <= 1e-5
    assert rel_l2(vae.decode_video(z)[0], want_img) <= 1e-5


def test_svd_vae_check_fails_after_writing(tmp_path, monkeypatch, capsys):
    """A source whose decoder blends the other way round (the open question
    of ``lfvdm_tpu/models/vae.py:166-168`` against diffusers') fails the
    decoder check, after the pair is written; the encoder still passes."""

    def flipped(self, x, num_frames):
        hs = self.spatial_res_block(x)
        BT, C, H, W = hs.shape
        h5 = hs.view(BT // num_frames, num_frames, C, H, W).permute(0, 2, 1, 3, 4)
        ht = self.temporal_res_block(h5)
        alpha = torch.sigmoid(self.time_mixer.mix_factor)
        out = (1 - alpha) * h5 + alpha * ht
        return out.permute(0, 2, 1, 3, 4).reshape(BT, C, H, W)

    monkeypatch.setattr(svd_fixture.SpatioTemporalResBlock, "forward", flipped)
    monkeypatch.setitem(sys.modules, "diffusers", _library(
        "diffusers", AutoencoderKLTemporalDecoder=svd_fixture.AutoencoderKLTemporalDecoder))
    prefix = str(tmp_path / "svd_vae")
    with pytest.raises(AssertionError):
        convert_svd_vae.main(["--out", prefix, "--device", "cpu"])
    assert "encoder validation OK" in capsys.readouterr().out
    assert (tmp_path / "svd_vae_encoder.npz").exists()
    assert (tmp_path / "svd_vae_decoder.npz").exists()


def test_vae_mappings_are_inverses():
    """``vae_jax_from_state_dict`` is the JAX script's ``convert`` and the
    exact inverse of ``vae_state_dict_from_jax``, both ways, on the tiny VAE."""
    vae, _ = tiny_vae_pair()
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    enc, dec = conv.vae_jax_from_state_dict(vae.state_dict())
    want_enc, want_dec = jax_convert_svd_vae.convert(sd)
    assert_same_arrays(conv.flatten_tree(enc), jax_convert_svd_vae.flatten(want_enc))
    assert_same_arrays(conv.flatten_tree(dec), jax_convert_svd_vae.flatten(want_dec))
    back = conv.vae_state_dict_from_jax(enc, dec)
    assert_same_arrays({k: v.numpy() for k, v in back.items()}, sd)
    again = conv.vae_jax_from_state_dict(conv.vae_state_dict_from_jax(want_enc, want_dec))
    assert_same_arrays(conv.flatten_tree(again[0]), jax_convert_svd_vae.flatten(want_enc))
    assert_same_arrays(conv.flatten_tree(again[1]), jax_convert_svd_vae.flatten(want_dec))


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------


def test_lpips_file_is_the_jax_scripts(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "lpips", _library("lpips", LPIPS=lpips_fixture.LPIPS))
    ours = str(tmp_path / "port" / "lpips_alex.npz")
    assert convert_lpips.main(["--out", ours, "--device", "cpu"]) == ours
    assert "validation OK" in capsys.readouterr().out
    jax_script = _import_from(ROOT / "scripts", "convert_lpips")
    theirs = str(tmp_path / "jax" / "lpips_alex.npz")
    monkeypatch.setattr(sys, "argv", ["convert_lpips.py", "--out", theirs])
    jax_script.main()  # with its own JAX check
    assert "validation OK" in capsys.readouterr().out
    assert_same_arrays(_read(ours), _read(theirs))


def test_lpips_check_fails_after_writing(tmp_path, monkeypatch):
    """A source whose distance is 1% off its weights' fails the check
    (rtol 1e-3) after the file is written."""

    class Wrong(lpips_fixture.LPIPS):
        def forward(self, x, y):
            return super().forward(x, y) * 1.01

    monkeypatch.setitem(sys.modules, "lpips", _library("lpips", LPIPS=Wrong))
    out = tmp_path / "lpips_alex.npz"
    with pytest.raises(AssertionError):
        convert_lpips.main(["--out", str(out), "--device", "cpu"])
    assert out.exists()


def test_lpips_mappings_are_inverses(tmp_path):
    module = LpipsEmbedderModule().seeded_init(3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    npz = conv.lpips_npz_from_state_dict(module.state_dict())
    assert npz["conv2.kernel"].shape == (5, 5, 64, 192) and npz["lin4"].shape == (256,)
    assert_same_arrays({k: v.numpy() for k, v in conv.lpips_state_dict_from_npz(npz).items()},
                       sd)
    assert_same_arrays(conv.lpips_npz_from_state_dict(conv.lpips_state_dict_from_npz(npz)), npz)
    np.savez(tmp_path / "w.npz", **npz)
    loaded = LpipsEmbedderModule().load_npz(str(tmp_path / "w.npz"))
    assert_same_arrays({k: v.detach().numpy() for k, v in loaded.state_dict().items()}, sd)


# ---------------------------------------------------------------------------
# I3D
# ---------------------------------------------------------------------------


def test_i3d_file_is_tf_var_to_flax_of_the_graph(tmp_path, monkeypatch, capsys):
    pytest.importorskip("tensorflow")
    tf_fixture = _import_from(FIXTURES, "tf_i3d_fixture")
    tf = tf_fixture.tf
    monkeypatch.setitem(sys.modules, "tensorflow_hub",
                        _library("tensorflow_hub", Module=tf_fixture.Module))
    out = str(tmp_path / "i3d.npz")
    assert convert_i3d.main(["--out", out, "--device", "cpu"]) == out
    assert "validation OK" in capsys.readouterr().out  # the port's I3D held to the TF logits
    with tf.Graph().as_default():
        tf_fixture.build_i3d(tf.placeholder(tf.float32, [1, 16, 224, 224, 3]))
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            want = dict(jax_convert_i3d.tf_var_to_flax(v.name.split(":")[0], sess.run(v))
                        for v in tf.global_variables())
    assert_same_arrays(_read(out), want)


def test_i3d_mappings_are_inverses():
    """TF-Hub variables -> ``.npz`` entries (``tf_var_to_flax``'s, bitwise)
    -> the port's state_dict -> the same variables, bitwise."""
    variables = tf_hub_variables(seed=5)
    npz = convert_i3d.convert({f"{k}:0": v for k, v in variables.items()})
    assert_same_arrays(npz, dict(jax_convert_i3d.tf_var_to_flax(k, v)
                                 for k, v in variables.items()))
    sd = conv.i3d_state_dict_from_jax(npz)
    I3D().load_state_dict(sd)  # strict: every name of the port's module
    assert_same_arrays(conv.i3d_tf_variables_from_state_dict(sd), variables)
    with pytest.raises(ValueError, match="not a variable"):
        conv.i3d_npz_entry_from_tf("Flow/inception_i3d/Conv3d_1a_7x7/conv_3d/w",
                                   npz["params/Conv3d_1a_7x7/conv_3d/kernel"])


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,library", [("convert_svd_vae", "diffusers"),
                                          ("convert_lpips", "lpips"),
                                          ("convert_i3d", "tensorflow"),
                                          ("convert_i3d", "tensorflow_hub")])
def test_missing_library_is_named(name, library, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, library, None)
    with pytest.raises(ImportError, match=library):
        PORT[name].main(["--out", str(tmp_path / "w"), "--device", "cpu"])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", list(PORT))
def test_default_device_is_the_card(name, tmp_path):
    """Without ``--device`` the converter asks for the card; here there is
    none, and it raises before it reads or writes anything."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[name].main(["--out", str(tmp_path / "w")])
    assert not list(tmp_path.iterdir())
