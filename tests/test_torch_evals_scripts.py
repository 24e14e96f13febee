"""The port's eval scripts (``video_to_world_coords``, ``video_make_mp4``,
``carla_regressor_train``) against the repo's JAX scripts on the same inputs,
on the CPU (``--device cpu``).

``video_to_world_coords`` runs with the JAX tests' stub predictor on both
sides: the same ``coords/*.npy`` files and inputs, and the same skipping.
``video_make_mp4`` writes gif and mp4 grids whose decoded frames are equal.
``carla_regressor_train`` runs 8 epochs of the classifier (the LR falls at
the 7th) and 2 of the regressor on a 3-video CARLA-layout fixture of 64 px
frames with a cut-down trunk
(``stage_sizes=(1, 1, 1, 1)``) and the same numpy-seeded weights on both
sides: the same exploded frame files, per-epoch losses within rtol 1e-4 of
the JAX script's printed ones, the same best epochs saved, and the best
checkpoint's parameters (the port's ``.pt``, JAX's keystr ``.npz``) within
relative L2 1e-4. The one difference is that format, by design.
"""

import importlib
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvdm_tpu.evals import carla_regressor as J
from lfvdm_tpu_torch.evals import carla_regressor as T
from lfvdm_tpu_torch.scripts import carla_regressor_train, video_make_mp4, video_to_world_coords
from lfvdm_tpu_torch.utils.convert import resnet152_state_dict_from_jax
from test_torch_evals_resnet import one_torch_thread  # noqa: F401
from test_torch_evals_resnet import SMALL, SmallTrunk, seeded_jax_variables

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _jax_script(name):
    sys.path.insert(0, str(SCRIPTS))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


# ---- video_to_world_coords ----


class _StubPredictor:
    """Records its inputs; returns each frame's mean pixel as both coords."""

    def __init__(self):
        self.calls = []

    def predict_coords(self, frames):
        frames = np.asarray(frames)
        self.calls.append((frames.shape, frames.dtype))
        return np.repeat(frames.reshape(len(frames), -1).mean(1, keepdims=True), 2, axis=1)


def _coords_both(tmp_path, monkeypatch, make_inputs, argv):
    """Both scripts on copies of one input tree: {which: (files, calls)}."""
    out = {}
    for which in ("port", "jax"):
        root = tmp_path / which
        make_inputs(root)
        stub = _StubPredictor()
        if which == "port":
            monkeypatch.setattr(video_to_world_coords, "load_classifier_regressor_like_paper",
                                lambda *a, **k: stub)
            video_to_world_coords.main([a.format(root=root) for a in argv] + ["--device", "cpu"])
        else:
            mod = _jax_script("video_to_world_coords")
            monkeypatch.setattr(mod, "load_classifier_regressor_like_paper",
                                lambda *a, **k: stub)
            monkeypatch.setattr(sys, "argv", ["video_to_world_coords.py"]
                                + [a.format(root=root) for a in argv])
            mod.main()
        files = {p.name: np.load(p) for p in sorted((root / "coords").glob("*.npy"))}
        out[which] = (files, sorted(stub.calls, key=str))
    return out


def _assert_same(out):
    (pf, pc), (jf, jc) = out["port"], out["jax"]
    assert sorted(pf) == sorted(jf) and pc == jc
    for name in pf:
        np.testing.assert_array_equal(pf[name], jf[name])


ARGV = ["--classifier_path", "c.pt", "--regressor_path", "r.pt"]


def test_world_coords_eval_dir_equals_jax_script(tmp_path, monkeypatch):
    def make(root):
        (root / "samples").mkdir(parents=True)
        rng = np.random.default_rng(0)
        for i in range(3):
            np.save(root / "samples" / f"sample_{i:04d}-0.npy",
                    rng.integers(0, 255, (4, 3, 8, 8), dtype=np.uint8))
        (root / "coords").mkdir()  # one video done already
        np.save(root / "coords" / "sample_0001-0.npy", np.full((4, 2), 7.0, np.float32))

    out = _coords_both(tmp_path, monkeypatch, make, ["--eval_dir", "{root}"] + ARGV)
    _assert_same(out)
    assert len(out["port"][1]) == 2 and out["port"][0]["sample_0001-0.npy"].max() == 7.0


def test_world_coords_dataset_dir_equals_jax_script(tmp_path, monkeypatch):
    def make(root):
        root.mkdir(parents=True)
        rng = np.random.default_rng(1)
        for i in range(2):
            torch.save(torch.from_numpy(rng.integers(0, 255, (5, 8, 8, 3), dtype=np.uint8)),
                       root / f"video_{i:05d}.pt")

    out = _coords_both(tmp_path, monkeypatch, make, ["--dataset_dir", "{root}"] + ARGV)
    _assert_same(out)
    assert out["port"][1] == [((5, 3, 8, 8), np.dtype(np.float32))] * 2


def test_world_coords_runs_the_predictor_from_pt_files(tmp_path, monkeypatch):
    """The predictor on torchvision-layout files of a cut-down trunk (full
    depth is held to JAX in test_torch_evals_resnet.py): one finite (T, 2)
    file per video, nothing rewritten on a second run."""
    paths = []
    for name, module in (("c", T.ResNet152Classifier(stage_sizes=SMALL)),
                         ("r", T.MultiHeadResNet152(stage_sizes=SMALL))):
        paths.append(str(tmp_path / f"{name}.pt"))
        torch.save(T.seeded_init(module).state_dict(), paths[-1])
    (tmp_path / "samples").mkdir()
    for i in range(2):
        np.save(tmp_path / "samples" / f"sample_{i:04d}-0.npy",
                np.random.default_rng(i).integers(0, 255, (3, 3, 32, 32), dtype=np.uint8))

    def small(classifier_path, regressor_path, batch_size, device):
        return T.CoordPredictor(
            T.load_state_dict_like_jax(T.ResNet152Classifier(stage_sizes=SMALL),
                                       torch.load(classifier_path)),
            T.load_state_dict_like_jax(T.MultiHeadResNet152(stage_sizes=SMALL),
                                       torch.load(regressor_path)),
            batch_size=2, device=device)

    monkeypatch.setattr(video_to_world_coords, "load_classifier_regressor_like_paper", small)
    argv = ["--eval_dir", str(tmp_path), "--classifier_path", paths[0],
            "--regressor_path", paths[1], "--device", "cpu"]
    written = video_to_world_coords.main(argv)
    assert sorted(p.name for p in written) == ["sample_0000-0.npy", "sample_0001-0.npy"]
    for p in written:
        c = np.load(p)
        assert c.shape == (3, 2) and c.dtype == np.float32 and np.isfinite(c).all()
    assert video_to_world_coords.main(argv) == []


# ---- video_make_mp4 ----


def _eval_dir(root, T=5, H=64):
    samples = root / "samples"
    samples.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for vi in range(2):
        for si in (0, 2):  # seed 1 missing: the search skips it
            np.save(samples / f"sample_{vi:04d}-{si}.npy",
                    rng.integers(0, 255, (T, 3, H, H), dtype=np.uint8))
    (root / "model_config.json").write_text(json.dumps({"dataset": "synthetic"}))


def _decode(path):
    if path.suffix == ".gif":
        from PIL import Image, ImageSequence

        return np.stack([np.asarray(f.convert("RGB"))
                         for f in ImageSequence.Iterator(Image.open(path))])
    import cv2

    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            return np.stack(frames)
        frames.append(frame)


@pytest.mark.parametrize("fmt", ["gif", "mp4"])
def test_make_mp4_equals_jax_script(tmp_path, monkeypatch, fmt):
    """Two videos with ground truth over two samples each (the dataset from
    model_config.json), observed frames marked: the same decoded frames."""
    argv = ["--do_n", "2", "--n_seeds", "2", "--obs_length", "2", "--format", fmt, "--T", "5"]
    for which in ("port", "jax"):
        _eval_dir(tmp_path / which)
        if which == "port":
            out = video_make_mp4.main(["--eval_dir", str(tmp_path / which), "--device", "cpu"]
                                      + argv)
        else:
            monkeypatch.setattr(sys, "argv", ["video_make_mp4.py", "--eval_dir",
                                              str(tmp_path / which)] + argv)
            _jax_script("video_make_mp4").main()
    assert out == tmp_path / "port" / "videos" / f"2_2.{fmt}"
    got, want = (_decode(tmp_path / w / "videos" / f"2_2.{fmt}") for w in ("port", "jax"))
    assert got.shape == (5, 3 * 64, 2 * 64, 3)
    np.testing.assert_array_equal(got, want)


# ---- carla_regressor_train ----


def write_carla_regressor_fixture(root, n_train=2, n_test=1, T=4, size=64, seed=0):
    """CARLA layout: video_{train,test}.csv, uint8 (T, size, size, 3) ``.pt``
    videos and (T, 3) ``coords_*.npy`` world coordinates in the Town01
    range."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    splits = {"train": [], "test": []}
    for i in range(n_train + n_test):
        name = f"video_{i:05d}.pt"
        torch.save(torch.from_numpy(rng.integers(0, 256, (T, size, size, 3), dtype=np.uint8)),
                   root / name)
        np.save(root / f"coords_{i:05d}.npy", rng.uniform(-10, 400, (T, 3)).astype(np.float32))
        splits["train" if i < n_train else "test"].append(name)
    for split, names in splits.items():
        (root / f"video_{split}.csv").write_text("".join(f"videos/{n}\n" for n in names))


def _from_keystr(npz):
    """JAX's keystr-flattened ``.npz`` -> the nested variables."""
    tree = {}
    for key, value in npz.items():
        *path, leaf = re.findall(r"\['([^']+)'\]", key)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.mark.parametrize("is_classifier,epochs", [(True, 8), (False, 2)],
                         ids=["classifier", "regressor"])
def test_carla_regressor_train_equals_jax_script(tmp_path, monkeypatch, capsys, is_classifier,
                                                 epochs):
    for which in ("port", "jax"):
        write_carla_regressor_fixture(tmp_path / which / "data")
    monkeypatch.setattr(J, "ResNet152Trunk", SmallTrunk)
    jscript = _jax_script("carla_regressor_train")
    jmodel = J.ResNet152Classifier() if is_classifier else J.MultiHeadResNet152()
    frames = jnp.zeros((4, 64, 64, 3))
    variables = seeded_jax_variables(
        jmodel, (frames,) if is_classifier else (frames, jnp.zeros(4, jnp.int32)), seed=4)

    class Seeded(type(jmodel)):
        def init(self, *args, **kwargs):
            return jax.tree_util.tree_map(jnp.asarray, variables)

    monkeypatch.setattr(jscript, "ResNet152Classifier" if is_classifier else "MultiHeadResNet152",
                        Seeded)

    def small(is_cls):
        model = (T.ResNet152Classifier(stage_sizes=SMALL) if is_cls
                 else T.MultiHeadResNet152(stage_sizes=SMALL))
        model.load_state_dict(resnet152_state_dict_from_jax(variables, multi_head=not is_cls))
        return model

    monkeypatch.setattr(carla_regressor_train, "build_model", small)
    # The regressor's MSE on world coordinates in the hundreds is ~5e4 at
    # init: at the default lr its eval-mode test loss swings between 1e4 and
    # 1e9 from epoch to epoch, which no two f32 implementations follow.
    lr = "0.001" if is_classifier else "1e-6"
    argv = ["--is_classifier", str(is_classifier), "--num_epochs", str(epochs), "--lr", lr]
    run = carla_regressor_train.main(argv + ["--data_dir", str(tmp_path / "port" / "data"),
                                             "--out_dir", str(tmp_path / "port" / "out"),
                                             "--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["carla_regressor_train.py"] + argv + [
        "--data_dir", str(tmp_path / "jax" / "data"), "--out_dir", str(tmp_path / "jax" / "out")])
    jscript.main()
    printed = re.findall(r"epoch (\d+): train ([\d.]+) test ([\d.]+)", capsys.readouterr().out)

    frames_dir = [sorted(p.relative_to(tmp_path / w / "data").as_posix()
                         for p in (tmp_path / w / "data" / "individual-frames").rglob("*.npy"))
                  for w in ("port", "jax")]
    assert frames_dir[0] == frames_dir[1] and len(frames_dir[0]) == 2 * 12
    assert len(printed) == len(run["epochs"]) == epochs
    for (_, train, test), got in zip(printed, run["epochs"]):
        np.testing.assert_allclose([got["train_loss"], got["test_loss"]],
                                   [float(train), float(test)], rtol=1e-4, atol=1e-4)
    saved = [sorted(int(p.stem.split("_")[1]) for p in (tmp_path / w / "out").iterdir())
             for w in ("port", "jax")]
    assert saved[0] == saved[1] == [int(Path(p).stem.split("_")[1]) for p in run["saved"]]

    best = saved[0][-1]
    got = torch.load(tmp_path / "port" / "out" / f"model_{best}.pt")
    want = resnet152_state_dict_from_jax(
        _from_keystr(np.load(tmp_path / "jax" / "out" / f"model_{best}.npz")),
        multi_head=not is_classifier)
    assert set(got) == set(want)
    for k in got:
        rel = np.linalg.norm(got[k].numpy() - want[k].numpy()) / np.linalg.norm(want[k].numpy())
        assert rel <= 1e-4 or np.abs(want[k].numpy()).max() == 0, k
    # The checkpoint is what the predictor loads.
    T.load_state_dict_like_jax(small(is_classifier), got)
