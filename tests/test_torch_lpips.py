"""Port vs JAX package: the LPIPS embedder (``evals/lpips.py``) and the
adaptive sampling schemes that default to it, on the CPU in f32.

Both embedders load one ``.npz`` written here from a JAX parameter tree
(random kernels, non-zero biases, head weights with negative entries so that
the clamp counts); their embeddings agree to 1e-5 relative, for 3-channel,
1-channel (tiled) and 4-channel (cut to 3) frames. ``||e(x) - e(y)||²`` is
symmetric and 0 on x = y. With ``$LFVDM_LPIPS_WEIGHTS`` naming that file, the
adaptive schemes' picks with their *default* embedder equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lfvdm_tpu.evals.lpips as jlpips
import lfvdm_tpu_torch.evals.lpips as tlpips
from lfvdm_tpu.sampling.schemes import sampling_schemes as j_schemes
from lfvdm_tpu_torch.sampling.schemes import sampling_schemes as t_schemes

SIZE = 32


def write_npz(path, seed=1):
    """A JAX embedder parameter tree in the converter's ``.npz`` layout."""
    params = jlpips.LpipsEmbedderModule().init(jax.random.PRNGKey(seed),
                                               jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1, 6):
        conv = params["net"][f"conv{i}"]
        out[f"conv{i}.kernel"] = np.asarray(conv["kernel"], np.float32)
        out[f"conv{i}.bias"] = rng.uniform(-0.1, 0.1, conv["bias"].shape).astype(np.float32)
    for i in range(5):
        out[f"lin{i}"] = rng.uniform(-0.2, 1.0, params[f"lin{i}"].shape).astype(np.float32)
    np.savez(path, **out)
    return str(path)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_npz(tmp_path_factory.mktemp("lpips") / "lpips.npz")


@pytest.fixture(scope="module")
def embedders(npz):
    return jlpips.LpipsEmbedder(npz, image_size=SIZE), tlpips.LpipsEmbedder(npz, device="cpu")


def frames(n, C=3, seed=0, size=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (n, C, size, size)).astype(np.float32)


@pytest.mark.parametrize("C", [3, 1, 4])
def test_embedding_matches_jax(embedders, C):
    j, t = embedders
    assert j.pretrained and t.pretrained
    x = frames(4, C)
    got, want = t(x), j(x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-4)


def test_embedding_matches_jax_at_64px(embedders):
    j, t = embedders
    x = frames(2, 3, seed=3, size=64)
    np.testing.assert_allclose(t(x), j(x), atol=1e-5 * np.abs(j(x)).max(), rtol=1e-4)


def test_distance_properties(embedders):
    _, t = embedders
    x, y = frames(3, seed=1), frames(3, seed=2)
    ex, ey = t(x), t(y)
    d_xy = ((ex - ey) ** 2).sum(-1)
    d_yx = ((ey - ex) ** 2).sum(-1)
    np.testing.assert_array_equal(d_xy, d_yx)
    assert (d_xy > 0).all()
    np.testing.assert_array_equal(((t(x) - ex) ** 2).sum(-1), 0.0)
    # Distances match JAX's embedder on the same weights.
    j = embedders[0]
    np.testing.assert_allclose(d_xy, ((j(x) - j(y)) ** 2).sum(-1), rtol=1e-4)


def test_random_backbone_is_seeded_and_says_so(monkeypatch, capsys):
    monkeypatch.delenv("LFVDM_LPIPS_WEIGHTS", raising=False)
    a, b = tlpips.LpipsEmbedder(device="cpu"), tlpips.LpipsEmbedder(device="cpu")
    assert "deterministic random backbone" in capsys.readouterr().out
    assert not a.pretrained
    x = frames(2)
    np.testing.assert_array_equal(a(x), b(x))
    assert np.isfinite(a(x)).all() and np.abs(a(x)).max() > 0
    tlpips.LpipsEmbedder("/nonexistent/lpips.npz", device="cpu")
    assert "not found at /nonexistent/lpips.npz" in capsys.readouterr().out


def _picks(schemes, name, videos, **kwargs):
    T = videos.shape[1]
    s = schemes[name](video_length=T, num_obs=3, max_frames=6, step_size=2, **kwargs)
    out = []
    while not s.is_done():
        s.set_videos(videos)
        out.append(next(s))
    return out


@pytest.mark.parametrize("name", ["adaptive-autoreg", "adaptive-hierarchy-2"])
def test_adaptive_schemes_with_the_default_embedder_match_jax(npz, monkeypatch, name):
    monkeypatch.setenv("LFVDM_LPIPS_WEIGHTS", npz)
    monkeypatch.setattr(jlpips, "_default", None)
    monkeypatch.setattr(tlpips, "_default", {})
    videos = np.random.default_rng(8).uniform(-1, 1, (2, 14, 3, SIZE, SIZE)).astype(np.float32)
    got = _picks(t_schemes, name, videos, device="cpu")
    assert tlpips.default_lpips_embedder("cpu").pretrained
    assert got == _picks(j_schemes, name, videos)
    assert any(o[0] != o[1] for o, _ in got[1:])  # per-video picks differ somewhere


def test_default_embedder_is_on_the_card():
    """Without a card, the default embedder (and so an adaptive scheme given
    no device) refuses instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlpips.default_lpips_embedder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_schemes["adaptive-autoreg"](video_length=8, num_obs=2, max_frames=4, step_size=2)


def test_video_sample_cli_with_an_adaptive_scheme(tmp_path, monkeypatch):
    """``--sampling_scheme adaptive-autoreg`` samples with the default
    embedder on the sampling device; the observed frames are kept."""
    from lfvdm_tpu_torch.data.datasets import get_test_dataset
    from lfvdm_tpu_torch.scripts import video_sample
    from test_torch_cli import CFG64, write_reference_pt

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LFVDM_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(tlpips, "_default", {})
    pt = tmp_path / "model.pt"
    write_reference_pt(pt, CFG64, dataset="synthetic", max_frames=4)
    run = video_sample.main([str(pt), "--sampling_scheme", "adaptive-autoreg", "--T", "8",
                             "--n_obs", "2", "--max_frames", "4", "--batch_size", "2",
                             "--use_ddim", "True", "--timestep_respacing", "ddim2",
                             "--device", "cpu"])
    assert list(tlpips._default) == [torch.device("cpu")]
    dataset = get_test_dataset("synthetic", T=8)
    assert run["model_calls"] == 3 * 2 and len(run["written"]) == 2  # 3 windows of DDIM-2
    for i, path in enumerate(run["written"]):
        video = np.load(path)
        assert video.shape == (8, 3, 64, 64)
        np.testing.assert_array_equal(video[:2], video_sample.to_uint8(dataset[i][:2]))
