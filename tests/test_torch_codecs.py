"""Port vs JAX package: the wavelet space, the four diffusion-space codecs,
``make_codec_from_config``'s order of resolution, and the pre-encoded latent
data (``load_encoding_stats``, ``EncodedNpyDataset``) on fixture files the
tests write (f32, CPU)."""

import numpy as np
import pytest
import torch

from lfvdm_tpu.data import datasets as jdata
from lfvdm_tpu.diffusion import codecs as jcodecs
from lfvdm_tpu.diffusion import wavelet as jwavelet
from lfvdm_tpu_torch.data import datasets as tdata
from lfvdm_tpu_torch.diffusion import codecs as tcodecs
from lfvdm_tpu_torch.diffusion import wavelet as twavelet
from test_torch_vae import PARITY, rel_l2, tiny_vae_pair, write_npz_pair

STATS_REL = tdata.data_encoding_stats_dict["synthetic_encoded"]


def frames(seed, shape=(2, 3, 3, 16, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return tiny_vae_pair(seed=1)


# ---- the wavelet space ----


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_wavelet_pack_and_unpack_match_jax(levels):
    x = frames(levels)
    got = twavelet.wavelet_pack(torch.from_numpy(x), levels)
    ref = np.asarray(jwavelet.wavelet_pack(x, levels))
    assert got.shape == (2, 3, 3 * 4 ** levels, 16 >> levels, 16 >> levels)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    y = frames(10 + levels, ref.shape)
    back = twavelet.wavelet_unpack(torch.from_numpy(y), levels)
    np.testing.assert_allclose(back.numpy(), np.asarray(jwavelet.wavelet_unpack(y, levels)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("levels", [1, 2])
def test_wavelet_round_trip_and_isometry(levels):
    x = torch.from_numpy(frames(20 + levels))
    y = twavelet.wavelet_pack(x, levels)
    torch.testing.assert_close(twavelet.wavelet_unpack(y, levels), x, atol=1e-6, rtol=0)
    torch.testing.assert_close(y.norm(), x.norm(), atol=0, rtol=1e-6)


def test_wavelet_refuses_odd_sizes_and_no_levels():
    with pytest.raises(ValueError, match="even"):
        twavelet.haar_dwt2(torch.zeros(1, 3, 5, 4))
    with pytest.raises(ValueError, match="4k channels"):
        twavelet.haar_idwt2(torch.zeros(1, 6, 4, 4))
    with pytest.raises(ValueError, match="levels"):
        twavelet.wavelet_pack(torch.zeros(1, 3, 4, 4), 0)


# ---- the codecs ----


def test_pixel_codec_is_the_identity():
    x = torch.from_numpy(frames(30))
    codec = tcodecs.PixelCodec()
    assert codec.encode(x) is x and codec.decode(x) is x
    assert (codec.diffusion_space, codec.pre_encoded) == (jcodecs.PixelCodec.diffusion_space,
                                                         jcodecs.PixelCodec.pre_encoded)


def test_wavelet_codec_matches_jax():
    x = frames(31)
    t, j = tcodecs.WaveletCodec(levels=2), jcodecs.WaveletCodec(levels=2)
    enc = t.encode(x)
    np.testing.assert_allclose(enc.numpy(), np.asarray(j.encode(x)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.decode(enc).numpy(), np.asarray(j.decode(enc.numpy())),
                               atol=1e-6, rtol=0)


def test_pre_encoded_codec_without_vae_matches_jax():
    rng = np.random.default_rng(32)
    mean, std = rng.standard_normal(4), rng.uniform(0.5, 2.0, 4)
    z = frames(33, (1, 5, 4, 8, 8))
    t = tcodecs.PreEncodedLatentCodec(mean=mean, std=std)
    j = jcodecs.PreEncodedLatentCodec(mean=mean, std=std)
    assert t.encode(z) is z
    np.testing.assert_allclose(t.decode(z).numpy(), np.asarray(j.decode(z)), atol=1e-6, rtol=1e-6)


def test_latent_codecs_with_the_vae_match_jax(pair):
    """VAECodec's encode (the mean) and decode, and the pre-encoded codec's
    de-normalize-then-decode, against the JAX codecs on the same VAE."""
    vae, jvae = pair
    x = np.random.default_rng(34).uniform(-1, 1, (1, 4, 3, 32, 32)).astype(np.float32)
    t, j = tcodecs.VAECodec(vae=vae, chunk_size=4), jcodecs.VAECodec(vae=jvae, chunk_size=4)
    z = t.encode(x)
    assert rel_l2(z.numpy(), np.asarray(j.encode(x))) <= PARITY
    assert rel_l2(t.decode(z).numpy(), np.asarray(j.decode(z.numpy()))) <= PARITY
    mean, std = np.full(4, 0.1, np.float32), np.full(4, 0.8, np.float32)
    tp = tcodecs.PreEncodedLatentCodec(mean=mean, std=std, vae=vae)
    jp = jcodecs.PreEncodedLatentCodec(mean=mean, std=std, vae=jvae)
    assert rel_l2(tp.decode(z).numpy(), np.asarray(jp.decode(z.numpy()))) <= PARITY


def test_make_codec_matches_jax_by_kind():
    stats = {"mean": np.zeros(4), "std": np.ones(4)}
    for kwargs in (dict(diffusion_space="pixel"), dict(diffusion_space=None),
                   dict(diffusion_space="wavelet", wavelet_levels=2),
                   dict(diffusion_space="latent", pre_encoded=True, pre_encoded_stats=stats)):
        t, j = tcodecs.make_codec(**kwargs), jcodecs.make_codec(**kwargs)
        assert type(t).__name__ == type(j).__name__
        assert (t.diffusion_space, t.pre_encoded) == (j.diffusion_space, j.pre_encoded)
    assert tcodecs.make_codec("wavelet", wavelet_levels=2).levels == 2
    with pytest.raises(ValueError, match="needs a VAE"):
        tcodecs.make_codec("latent")
    with pytest.raises(ValueError, match="norm stats"):
        tcodecs.make_codec("latent", pre_encoded=True)
    with pytest.raises(ValueError, match="Unknown"):
        tcodecs.make_codec("fourier")


def _write_stats(root, mean, std):
    path = root / STATS_REL
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"mean": torch.tensor(mean), "std": torch.tensor(std)}, path)


def test_make_codec_from_config_order(tmp_path, monkeypatch, capsys, pair):
    monkeypatch.setenv("DATA_ROOT", str(tmp_path))
    monkeypatch.delenv("LFVDM_VAE_WEIGHTS", raising=False)
    _write_stats(tmp_path, [1.0, 2.0, 3.0, 4.0], [0.5, 0.5, 0.5, 0.5])
    base = dict(diffusion_space="latent", pre_encoded=True, dataset="synthetic_encoded",
                in_channels=4)
    make = tcodecs.make_codec_from_config

    assert isinstance(make(dict(diffusion_space="pixel")), tcodecs.PixelCodec)
    wave = make(dict(diffusion_space="wavelet", wavelet_levels=2))
    assert isinstance(wave, tcodecs.WaveletCodec) and wave.levels == 2

    # 1. the stats embedded in the config win over the registry's file
    c = make(dict(base, enc_stats_mean=[0.0] * 4, enc_stats_std=[2.0] * 4))
    assert c.vae is None and c.mean.ravel().tolist() == [0.0] * 4 and c.std.ravel()[0] == 2.0
    # 2. then the registry's stats file
    c = make(base)
    assert c.mean.ravel().tolist() == [1.0, 2.0, 3.0, 4.0] and c.std.ravel()[0] == 0.5
    j = jcodecs.make_codec_from_config(base)
    np.testing.assert_array_equal(c.mean, j.mean)
    np.testing.assert_array_equal(c.std, j.std)
    # 3. then identity stats, with the warning
    c = make(dict(base, dataset="carla_no_traffic_2x_encoded", in_channels=3))
    assert "identity stats" in capsys.readouterr().out
    assert c.mean.ravel().tolist() == [0.0] * 3 and c.std.ravel().tolist() == [1.0] * 3

    # The VAE: vae_weights=, then $LFVDM_VAE_WEIGHTS, then require_vae.
    vae, jvae = pair
    prefix = str(tmp_path / "svd_vae")
    write_npz_pair(jvae, prefix)
    c = make(base, vae_weights=prefix, device="cpu")
    assert c.vae.pretrained
    assert torch.equal(c.vae.state_dict()["quant_conv.weight"], vae.state_dict()["quant_conv.weight"])
    monkeypatch.setenv("LFVDM_VAE_WEIGHTS", prefix)
    online = make(dict(base, pre_encoded=False), device="cpu")
    assert isinstance(online, tcodecs.VAECodec) and online.vae.pretrained
    monkeypatch.delenv("LFVDM_VAE_WEIGHTS")
    c = make(base, require_vae=True, device="cpu")
    assert not c.vae.pretrained and c.vae.encoder.conv_in.out_channels == 128
    assert c.vae.decoder.conv_in.out_channels == 512 and c.vae.device.type == "cpu"
    # An online latent config with no VAE raises.
    with pytest.raises(ValueError, match="VAE weights"):
        make(dict(base, pre_encoded=False), device="cpu")


# ---- the pre-encoded latent data ----


def test_load_encoding_stats_resolution(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DATA_ROOT", raising=False)
    assert tdata.load_encoding_stats("synthetic_encoded") is None  # no file yet
    assert tdata.load_encoding_stats("minerl") is None  # not a pre-encoded dataset
    assert tdata.load_encoding_stats(None) is None
    _write_stats(tmp_path, [0.5, 1.5], [2.0, 3.0])
    got = tdata.load_encoding_stats("synthetic_encoded")
    ref = jdata.load_encoding_stats("synthetic_encoded")
    for k in ("mean", "std"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["mean"].tolist() == [0.5, 1.5]
    # A cold DATA_ROOT cache falls back to the source layout; a warm one wins.
    monkeypatch.setenv("DATA_ROOT", str(tmp_path / "cache"))
    assert tdata.load_encoding_stats("synthetic_encoded")["std"].tolist() == [2.0, 3.0]
    _write_stats(tmp_path / "cache", [7.0, 7.0], [1.0, 1.0])
    assert tdata.load_encoding_stats("synthetic_encoded")["mean"].tolist() == [7.0, 7.0]


def _write_latent_videos(directory, n=3, T=12, C=4, S=8):
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(40)
    videos = [rng.standard_normal((T, C, S, S)).astype(np.float32) for _ in range(n)]
    for i, v in enumerate(videos):
        np.save(directory / f"{i}.npy", v)
    return videos


def test_encoded_npy_dataset_matches_jax(tmp_path):
    videos = _write_latent_videos(tmp_path / "train")
    t = tdata.EncodedNpyDataset(tmp_path / "train", T=5)
    j = jdata.EncodedNpyDataset(tmp_path / "train", T=5)
    assert len(t) == len(j) == 3
    for i in range(3):
        np.random.seed(i)
        a = t[i]
        np.random.seed(i)
        np.testing.assert_array_equal(a, j[i])
        assert a.shape == (5, 4, 8, 8) and a.dtype == np.float32
        start = next(s for s in range(8) if np.array_equal(videos[i][s:s + 5], a))
        assert 0 <= start <= 7
    t.set_test()
    np.testing.assert_array_equal(t[1], videos[1][:5])  # test mode: the prefix
    assert tdata.EncodedNpyDataset(tmp_path / "train", T=None)[2].shape == (12, 4, 8, 8)


def test_synthetic_encoded_load_data(tmp_path, monkeypatch):
    """The registry name reads ``train/{idx}.npy`` from the source layout
    and copies each file into the DATA_ROOT cache on first read."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DATA_ROOT", str(tmp_path / "cache"))
    src = tmp_path / tdata.video_data_paths_dict["synthetic_encoded"] / "train"
    _write_latent_videos(src)
    batches = tdata.load_data("synthetic_encoded", batch_size=2, T=5, seed=3)
    for _ in range(3):
        b = next(batches)
        assert b.shape == (2, 5, 4, 8, 8) and b.dtype == np.float32
    cached = sorted(p.name for p in (tmp_path / "cache" / src.relative_to(tmp_path)).iterdir()
                    if p.suffix == ".npy")
    assert cached == ["0.npy", "1.npy", "2.npy"]
    ds = tdata.load_data("synthetic_encoded", batch_size=1, return_dataset=True)
    assert isinstance(ds, tdata.EncodedNpyDataset) and ds.T == 100
    with pytest.raises(ValueError, match="not shardable"):
        tdata._build_dataset("synthetic_encoded", 5, None, num_shards=2)
    with pytest.raises(ValueError, match="image_size"):
        tdata.load_data("synthetic_encoded", batch_size=1, image_size=32)
