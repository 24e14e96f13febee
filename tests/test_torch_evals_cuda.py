"""The evals on the card against the same modules on the CPU.

Marked ``cuda``: each test skips without a CUDA device. On a machine with a
card, and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_evals_cuda.py

The evals run cuDNN convolutions in full f32 (TF32 off inside
``utils.device.full_f32``); the CPU path is what the CPU tests hold to the
JAX package. Tolerances: relative L2 1e-3 for I3D and ResNet-152 (cuDNN's
algorithms sum in other orders); 1e-4 for the resize in [-1, 1] units, 1/80
of one uint8 step (PyTorch's CUDA antialias kernel forms its weights in
another order than the CPU's: 1.56e-5 at 256 px on an H100).
"""

import numpy as np
import pytest
import torch

from lfvdm_tpu_torch.evals import carla_regressor as cr
from lfvdm_tpu_torch.evals.fvd import preprocess_videos
from lfvdm_tpu_torch.evals.i3d import I3DFeatureExtractor

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_i3d_card_matches_cpu(card):
    clip = np.random.default_rng(0).uniform(-1, 1, (1, 16, 224, 224, 3)).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    got = I3DFeatureExtractor(device=card)(clip)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == tf32
    want = I3DFeatureExtractor(device="cpu")(clip)
    assert got.shape == (1, 400) and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-3


def test_resnet152_card_matches_cpu(card):
    frames = np.random.default_rng(1).integers(0, 256, (4, 3, 128, 128)).astype(np.float32)
    out = {}
    for device in (card, torch.device("cpu")):
        pred = cr.CoordPredictor(cr.seeded_init(cr.ResNet152Classifier()),
                                 cr.seeded_init(cr.MultiHeadResNet152(), seed=1), device=device)
        x = torch.as_tensor(cr.normalize_frames(frames), device=device)
        with torch.no_grad():
            logits = pred.classifier(x).cpu().numpy()
        out[device.type] = logits, pred.predict_coords(frames)
    assert _rel(out["cuda"][0], out["cpu"][0]) <= 1e-3
    assert (out["cuda"][0].argmax(1) == out["cpu"][0].argmax(1)).all()
    assert np.isfinite(out["cuda"][1]).all() and _rel(out["cuda"][1], out["cpu"][1]) <= 1e-3


@pytest.mark.parametrize("size", [128, 256])
def test_resize_card_matches_cpu(card, size):
    videos = np.random.default_rng(size).integers(0, 256, (2, 4, size, size, 3), dtype=np.uint8)
    got = preprocess_videos(videos, device=card)
    want = preprocess_videos(videos, device="cpu")
    assert got.shape == (2, 4, 224, 224, 3)
    err = np.abs(got - want).max()
    assert err <= 1e-4, err
