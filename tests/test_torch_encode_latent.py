"""Port vs JAX package: the CARLA latent pre-encoding script (tiny VAE, CPU).

The port's ``lfvdm_tpu_torch.scripts.encode_latent.main`` runs with
``--device cpu`` on one copy of a tiny CARLA layout (3 train and 2 test uint8
(3, 16, 16, 3) ``.pt`` videos, and a CSV line without ``.pt`` that both
scripts skip); the repo's ``datasets/carla/encode_latent.py`` runs its
``main()`` (``runpy``, ``sys.argv`` patched) on another. Both read the same
``--vae_weights`` pair, the tiny VAE of ``test_torch_vae.py`` (4 blocks of 32
channels). T = 3 frames in chunks of 3, so each JAX run compiles the encoder
once. Held: the encoded means (relative L2, f32), the statistics and every
normalized file, both splits; the pixel preparation bit for bit against the
JAX script's numpy expression.
"""

import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.data.datasets import _build_dataset, load_encoding_stats
from lfvdm_tpu_torch.scripts import encode_latent
from test_torch_vae import rel_l2, tiny_vae_pair, write_npz_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "datasets", "carla", "encode_latent.py")
LAYOUT = os.path.join("datasets", "carla", "no-traffic-encoded")  # the registry's directory
T, SIZE, CHUNK = 3, 16, 3  # 16 px, upsampled to 32: 4x4 latents
SPLITS = {"train": ["video_0.pt", "video_1.pt", "video_2.pt"],
          "test": ["video_3.pt", "video_4.pt"]}
PARITY = 1e-5  # relative L2, f32 on both sides


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (it shares the CPU with the
    other test workers). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def write_layout(root):
    """The tiny CARLA layout in ``root``: seeded uint8 videos and the split
    CSVs, whose first line names no ``.pt`` file."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for mode, names in SPLITS.items():
        with open(os.path.join(root, f"video_{mode}.csv"), "w") as f:
            f.write("no-traffic/README.txt\n")
            f.write("".join(f"no-traffic/{n}\n" for n in names))
        for n in names:
            video = rng.integers(0, 256, (T, SIZE, SIZE, 3), dtype=np.uint8)
            torch.save(torch.from_numpy(video), os.path.join(root, n))


def run_jax(path, prefix, normalize):
    argv = ["encode_latent.py", "--path", path, "--vae_weights", prefix,
            "--chunk_size", str(CHUNK)] + (["--normalize"] if normalize else [])
    saved = sys.argv
    sys.argv = argv
    try:
        runpy.run_path(JAX_SCRIPT, run_name="__main__")
    finally:
        sys.argv = saved


def run_port(path, prefix, normalize):
    return encode_latent.main(["--path", path, "--vae_weights", prefix, "--chunk_size",
                               str(CHUNK), "--device", "cpu"]
                              + (["--normalize"] if normalize else []))


def encoded(path):
    return {n: torch.load(os.path.join(path, "encoded_" + n), weights_only=True).numpy()
            for names in SPLITS.values() for n in names}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts on their own copy of one layout, first without
    ``--normalize``, then with it; the files after each."""
    tmp = tmp_path_factory.mktemp("encode_latent")
    _, jvae = tiny_vae_pair()
    prefix = str(tmp / "svd_vae")
    write_npz_pair(jvae, prefix)
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port" / LAYOUT)
    write_layout(jax_dir)
    shutil.copytree(jax_dir, port_dir)
    out = {"dir": tmp, "prefix": prefix, "port_dir": port_dir}
    for normalize in (False, True):
        run_jax(jax_dir, prefix, normalize)
        out[("stats", normalize)] = run_port(port_dir, prefix, normalize)
        out[("jax", normalize)], out[("port", normalize)] = encoded(jax_dir), encoded(port_dir)
    out["jax_stats"] = torch.load(os.path.join(jax_dir, encode_latent.STATS_FILE),
                                  weights_only=True)
    out["port_stats"] = torch.load(os.path.join(port_dir, encode_latent.STATS_FILE),
                                   weights_only=True)
    return out


def test_encoded_means_match_jax(runs):
    jax_files, port_files = runs[("jax", False)], runs[("port", False)]
    assert set(port_files) == {n for names in SPLITS.values() for n in names}
    for name, want in jax_files.items():
        got = port_files[name]
        assert got.dtype == np.float32 and got.shape == (T, 4, 2 * SIZE // 8, 2 * SIZE // 8)
        assert rel_l2(got, want) <= PARITY, name


def test_stats_match_jax(runs):
    want, got = runs["jax_stats"], runs["port_stats"]
    assert set(got) == {"mean", "std", "n_obs"}
    assert got["mean"].shape == (4,) and got["std"].shape == (4,)
    assert got["mean"].dtype == got["std"].dtype == torch.float32
    assert int(got["n_obs"]) == int(want["n_obs"]) == len(SPLITS["train"]) * T * 4 * 4
    for key in ("mean", "std"):
        assert rel_l2(got[key].numpy(), want[key].numpy()) <= PARITY, key
    returned = runs[("stats", True)]
    assert np.array_equal(returned["mean"], got["mean"].numpy()) and runs[("stats", False)] is None


def test_normalized_files_match_jax(runs):
    """Every file of both splits, the test split normalized with the train
    split's statistics."""
    jax_files, port_files = runs[("jax", True)], runs[("port", True)]
    for name, want in jax_files.items():
        assert rel_l2(port_files[name], want) <= PARITY, name
    stats = runs["port_stats"]
    mean, std = (stats[k].numpy().reshape(1, 4, 1, 1) for k in ("mean", "std"))
    for name, raw in runs[("port", False)].items():
        np.testing.assert_array_equal(port_files[name], (raw - mean) / (std + 1e-8))


def test_pixel_preparation_is_numpys_bit_for_bit():
    """Every uint8 value, and a video, through the JAX script's expression."""
    rng = np.random.default_rng(1)
    video = rng.integers(0, 256, (4, 8, 16, 3), dtype=np.uint8)
    video.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    want = video.astype(np.float32) / 255.0
    want = (2 * want - 1).transpose(0, 3, 1, 2)
    want = np.repeat(np.repeat(want, 2, axis=2), 2, axis=3)
    table = torch.from_numpy(encode_latent.pixel_table())
    got = encode_latent.prepare_frames(torch.from_numpy(video), table).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), np.ascontiguousarray(want).view(np.uint32))


def test_training_reads_the_port_files(runs, monkeypatch):
    """The registry's stats reader and the pre-encoded CARLA dataset read what
    the port wrote."""
    monkeypatch.setenv("DATA_ROOT", str(runs["dir"] / "port"))
    stats = load_encoding_stats("carla_no_traffic_2x_encoded")
    assert np.array_equal(stats["mean"], runs["port_stats"]["mean"].numpy())
    assert np.array_equal(stats["std"], runs["port_stats"]["std"].numpy())
    dataset = _build_dataset("carla_no_traffic_2x_encoded", T, train=False)
    dataset.set_test()
    assert len(dataset) == len(SPLITS["test"])
    assert np.array_equal(dataset[0], runs[("port", True)][SPLITS["test"][0]])


def test_cuda_without_a_card_raises(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_latent.main(["--path", runs["port_dir"], "--vae_weights", runs["prefix"]])
