"""The port's FVD stack (``lfvdm_tpu_torch.evals.i3d`` / ``evals.fvd`` and
the ``video_fvd`` CLI) against the JAX package on the CPU, f32.

The I3D weights are drawn from a numpy seed in the TF-Hub graph's variable
names and layouts and written to the JAX package's ``.npz`` through the
repo's ``scripts/convert_i3d.py::tf_var_to_flax``, so the converter's key
mapping is checked too; both packages read that one file. JAX's Flax ``init``
of I3D (about a minute on a CPU) is never called. Tolerances: I3D relative
L2 <= 1e-4 (f32, summation order only); the preprocessing 1e-5 in [-1, 1]
units; the Fréchet distance and KID of the same features rtol 1e-9 (the same
float64 numpy); an FVD from the two packages' features rtol 1e-4.
"""

import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.evals import fvd as jfvd
from lfvdm_tpu.evals.i3d import I3DFeatureExtractor as JExtractor
from lfvdm_tpu_torch.evals import fvd as tfvd
from lfvdm_tpu_torch.evals.i3d import I3D, I3DFeatureExtractor, Unit3D, same_pads
from lfvdm_tpu_torch.scripts import video_fvd
from lfvdm_tpu_torch.utils.convert import i3d_state_dict_from_jax
from test_torch_evals_resnet import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _jax_script(name):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


tf_var_to_flax = _jax_script("convert_i3d").tf_var_to_flax


def tf_hub_variables(seed=0):
    """Seeded variables of the hub graph, by its names and layouts: conv
    kernels (kt, kh, kw, in, out) with variance 2/fan_in, BatchNorm beta and
    moments of shape (1, 1, 1, 1, C), the logits conv's bias."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, unit in I3D().named_modules():
        if not isinstance(unit, Unit3D):
            continue
        base = "RGB/inception_i3d/" + name.replace(".", "/")
        cout, cin, *k = unit.weight.shape
        fan_in = cin * int(np.prod(k))
        out[f"{base}/conv_3d/w"] = (rng.standard_normal((*k, cin, cout))
                                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if unit.use_bn:
            c = (1, 1, 1, 1, cout)
            out[f"{base}/batch_norm/beta"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            out[f"{base}/batch_norm/moving_mean"] = (0.1 * rng.standard_normal(c)).astype(
                np.float32)
            out[f"{base}/batch_norm/moving_variance"] = rng.uniform(0.5, 2.0, c).astype(
                np.float32)
        else:
            out[f"{base}/conv_3d/b"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def i3d_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("i3d") / "i3d.npz"
    np.savez(path, **dict(tf_var_to_flax(k, v) for k, v in tf_hub_variables().items()))
    return str(path)


@pytest.fixture(scope="module")
def extractors(i3d_npz):
    return I3DFeatureExtractor(i3d_npz, device="cpu"), JExtractor(i3d_npz)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n,k,s,want", [(224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
                                        (16, 7, 2, (2, 3)), (15, 3, 1, (1, 1)),
                                        (7, 2, 2, (0, 1)), (8, 1, 1, (0, 0))])
def test_same_pads_are_tf_same(n, k, s, want):
    assert same_pads([n], [k], [s]) == list(want)


@pytest.mark.parametrize("shape", [(2, 16, 32, 32, 3), (1, 15, 36, 36, 3)],
                         ids=["moving_average_head", "odd_shape"])
def test_i3d_matches_jax(extractors, shape):
    """T = 16 leaves T' = 2 (the window-2 moving average of the head); 15
    frames of 36 px pad asymmetrically at every stride-2 layer."""
    port, jax_ext = extractors
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    got = port(x)
    want = np.asarray(jax.jit(jax_ext.module.apply)(jax_ext.variables, jnp.asarray(x)))
    assert got.shape == (shape[0], 400)
    assert _rel(got, want) <= 1e-4


def test_i3d_weights_from_nested_variables(i3d_npz, extractors):
    """The nested variables dict the JAX extractor builds from the ``.npz``
    converts to the same state_dict as the flat file, and it fills every
    parameter and buffer of the module."""
    flat = i3d_state_dict_from_jax(dict(np.load(i3d_npz)))
    nested = i3d_state_dict_from_jax(extractors[1].variables)
    assert set(flat) == set(nested) == set(I3D().state_dict())
    for k in flat:
        torch.testing.assert_close(flat[k], nested[k], rtol=0, atol=0)


def test_i3d_without_weights_is_seeded(monkeypatch, capsys):
    monkeypatch.delenv("LFVDM_I3D_WEIGHTS", raising=False)
    a = I3DFeatureExtractor(device="cpu")
    assert not a.pretrained and "I3D weights unavailable" in capsys.readouterr().out
    b = I3DFeatureExtractor(device="cpu")
    for (k, v), w in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("size", [32, 128, 256])
def test_preprocess_videos_matches_jax(size):
    """Growing to 224 px without antialiasing, shrinking with it, as
    ``jax.image.resize`` does."""
    videos = np.random.default_rng(size).integers(0, 256, (2, 3, size, size, 3), dtype=np.uint8)
    got = tfvd.preprocess_videos(videos, device="cpu")
    want = jfvd.preprocess_videos(videos)
    assert got.shape == want.shape == (2, 3, 224, 224, 3)
    assert np.abs(got - want).max() <= 1e-5


def test_frechet_distance_and_kid_equal_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 16))
    b = 0.5 + 1.2 * rng.standard_normal((40, 16))
    for x, y in ((a, b), (a, a), (b, a)):
        np.testing.assert_allclose(tfvd.frechet_distance(x, y), jfvd.frechet_distance(x, y),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tfvd.kid(x, y, n_subsets=5), jfvd.kid(x, y, n_subsets=5),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tfvd.polynomial_kernel(a, b), jfvd.polynomial_kernel(a, b),
                               rtol=1e-12)


def _synthetic_samples(samples_dir, n, T, size, seed, sample_idx=0):
    samples_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.save(samples_dir / f"sample_{i:04d}-{sample_idx}.npy",
                rng.integers(0, 256, (T, 3, size, size), dtype=np.uint8))


def _recording(fvd):
    """``fvd`` whose ``extract_features`` keeps what it returns."""
    fvd.features = []
    inner = fvd.extract_features
    fvd.extract_features = lambda videos: fvd.features.append(inner(videos)) or fvd.features[-1]
    return fvd


def test_compute_fvd_matches_jax_script(i3d_npz, tmp_path, monkeypatch):
    """4 videos of 8 frames at 32 px against the synthetic test set (64 px),
    both resized to 224: each side's features from both packages to 1e-4,
    the score to rtol 1e-4."""
    _synthetic_samples(tmp_path / "samples", 4, 8, 32, seed=5)
    jscript = _jax_script("video_fvd")
    fvds = {"port": _recording(tfvd.FVD(i3d_npz, batch_size=4, device="cpu")),
            "jax": _recording(jfvd.FVD(i3d_npz, batch_size=4))}
    monkeypatch.setattr(video_fvd, "FVD", lambda **kw: fvds["port"])
    monkeypatch.setattr(jscript, "FVD", lambda **kw: fvds["jax"])
    kw = dict(i3d_weights=i3d_npz, batch_size=4)
    got = video_fvd.compute_fvd(tmp_path, "synthetic", 4, 0, 8, device="cpu", **kw)
    want = jscript.compute_fvd(tmp_path, "synthetic", 4, 0, 8, **kw)
    assert len(fvds["port"].features) == len(fvds["jax"].features) == 2  # fake, real
    for a, b in zip(fvds["port"].features, fvds["jax"].features):
        assert a.shape == (4, 400) and _rel(a, b) <= 1e-4
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_video_fvd_main_matches_jax_script(i3d_npz, tmp_path, monkeypatch):
    """``--real_dir`` and ``--temporal_stride 2`` with a zero-padded last
    batch: the same ``fvd-3-0-s2.txt`` name and score as the JAX script, a
    second run reads the file back, and ``--dp_devices 2`` on a host with one
    device (the CPU) raises the JAX script's refusal."""
    for which in ("port", "jax"):
        _synthetic_samples(tmp_path / which / "samples", 3, 8, 32, seed=7)
        (tmp_path / which / "model_config.json").write_text(json.dumps({"dataset": "x", "T": 8}))
    _synthetic_samples(tmp_path / "real", 3, 8, 32, seed=8)
    argv = ["--num_videos", "3", "--real_dir", str(tmp_path / "real"), "--temporal_stride", "2",
            "--batch_size", "2", "--i3d_weights", i3d_npz]
    got = video_fvd.main(["--eval_dir", str(tmp_path / "port"), "--device", "cpu"] + argv)
    jscript = _jax_script("video_fvd")
    monkeypatch.setenv("LFVDM_COMPILE_CACHE", "")
    monkeypatch.setattr(sys, "argv", ["video_fvd.py", "--eval_dir", str(tmp_path / "jax")] + argv)
    jscript.main()
    out = [sorted(p.name for p in (tmp_path / w).glob("fvd-*")) for w in ("port", "jax")]
    assert out[0] == out[1] == ["fvd-3-0-s2.txt"]
    text = [float((tmp_path / w / "fvd-3-0-s2.txt").read_text()) for w in ("port", "jax")]
    assert text[0] == got
    np.testing.assert_allclose(text[0], text[1], rtol=1e-4)

    stamp = (tmp_path / "port" / "fvd-3-0-s2.txt").stat().st_mtime_ns
    assert video_fvd.main(["--eval_dir", str(tmp_path / "port"), "--device", "cpu"] + argv) == got
    assert (tmp_path / "port" / "fvd-3-0-s2.txt").stat().st_mtime_ns == stamp
    with pytest.raises(ValueError, match=r"^--dp_devices 2 > 1 visible devices$"):
        video_fvd.main(["--eval_dir", str(tmp_path / "port"), "--dp_devices", "2",
                        "--device", "cpu"] + argv[2:])


def test_features_split_over_two_devices(i3d_npz):
    """``devices=[cpu, cpu]``: one replica per device, each taking its block
    of rows: the one-device features of each block, bitwise; a batch the
    devices do not divide runs on the first."""
    clips = np.random.default_rng(11).uniform(-1, 1, (3, 8, 224, 224, 3)).astype(np.float32)
    one = I3DFeatureExtractor(i3d_npz, device="cpu")
    two = I3DFeatureExtractor(i3d_npz, devices=[torch.device("cpu")] * 2)
    assert len(two.replicas) == 2 and two.replicas[1] is not two.module
    np.testing.assert_array_equal(two(clips[:2]), np.concatenate([one(clips[:1]), one(clips[1:2])]))
    np.testing.assert_array_equal(two(clips), one(clips))


def test_real_dataset_name_equals_jax_script():
    jscript = _jax_script("video_fvd")
    for name in ("carla_no_traffic_2x_encoded", "carla_no_traffic", "synthetic"):
        assert video_fvd.real_dataset_name(name) == jscript.real_dataset_name(name)
    assert video_fvd.BATCH_SIZES == jscript.BATCH_SIZES
