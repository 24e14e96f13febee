"""The PyTorch port imports neither JAX nor the JAX package.

An AST scan of every module of ``lfvdm_tpu_torch`` and of ``chip_smoke.py``
(which runs on a machine without JAX) for ``import`` statements naming
``jax``, ``flax``, ``optax``, ``orbax``, ``lfvdm_tpu``, the repo's
``scripts``, ``diffusers`` (on neither machine) or ``msgpack`` (not on the
card's machine: the port reads and writes flax's files itself); and the
latent slice's modules, the entry points and their data, checkpoint and
logging modules, the LPIPS embedder, the optimal-schedule script, the evals
(FVD, I3D, the CARLA regressor) with their four scripts, and the serving
module, the msgpack reader and writer, the two export scripts and the
parallel package (meshes and sharding) imported in a fresh interpreter where
those names cannot be found.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "lfvdm_tpu", "scripts", "diffusers", "msgpack")
FILES = sorted((ROOT / "lfvdm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for expected in ("lfvdm_tpu_torch/config.py", "lfvdm_tpu_torch/models/unet.py",
                     "lfvdm_tpu_torch/ops/attention.py", "lfvdm_tpu_torch/sampling/driver.py",
                     "lfvdm_tpu_torch/ops/skipconv.py", "lfvdm_tpu_torch/training/train_loop.py",
                     "lfvdm_tpu_torch/training/checkpoint.py", "lfvdm_tpu_torch/models/vae.py",
                     "lfvdm_tpu_torch/diffusion/codecs.py", "lfvdm_tpu_torch/diffusion/wavelet.py",
                     "lfvdm_tpu_torch/data/datasets.py", "lfvdm_tpu_torch/data/native_loader.py",
                     "lfvdm_tpu_torch/scripts/video_sample.py",
                     "lfvdm_tpu_torch/scripts/video_train.py",
                     "lfvdm_tpu_torch/training/vis_sampling.py", "lfvdm_tpu_torch/utils/paths.py",
                     "lfvdm_tpu_torch/utils/rng.py", "lfvdm_tpu_torch/utils/video_io.py",
                     "lfvdm_tpu_torch/utils/logger.py", "lfvdm_tpu_torch/evals/lpips.py",
                     "lfvdm_tpu_torch/scripts/video_optimal_schedule.py",
                     "lfvdm_tpu_torch/evals/fvd.py", "lfvdm_tpu_torch/evals/i3d.py",
                     "lfvdm_tpu_torch/evals/carla_regressor.py",
                     "lfvdm_tpu_torch/scripts/video_fvd.py",
                     "lfvdm_tpu_torch/scripts/video_to_world_coords.py",
                     "lfvdm_tpu_torch/scripts/video_make_mp4.py",
                     "lfvdm_tpu_torch/scripts/carla_regressor_train.py",
                     "lfvdm_tpu_torch/serving.py", "lfvdm_tpu_torch/utils/msgpack.py",
                     "lfvdm_tpu_torch/scripts/export_sampler.py",
                     "lfvdm_tpu_torch/scripts/export_params.py",
                     "lfvdm_tpu_torch/parallel/__init__.py", "lfvdm_tpu_torch/parallel/mesh.py",
                     "lfvdm_tpu_torch/parallel/sharding.py", "chip_smoke.py"):
        assert expected in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_only_the_jax_side():
    assert _forbidden("jax.numpy") and _forbidden("flax.linen") and _forbidden("lfvdm_tpu.ops")
    assert _forbidden("optax") and _forbidden("orbax.checkpoint")
    assert _forbidden("scripts.convert_svd_vae") and _forbidden("diffusers")
    assert _forbidden("msgpack") and not _forbidden("lfvdm_tpu_torch.utils.msgpack")
    assert not _forbidden("lfvdm_tpu_torch.ops") and not _forbidden("torch")


BLOCKER = """
import importlib.abc, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import lfvdm_tpu_torch.models.vae, lfvdm_tpu_torch.diffusion.codecs
import lfvdm_tpu_torch.diffusion.wavelet, lfvdm_tpu_torch.data.datasets
import lfvdm_tpu_torch.utils.convert, lfvdm_tpu_torch.sampling.driver
import lfvdm_tpu_torch.training.train_loop, lfvdm_tpu_torch.config, chip_smoke
import lfvdm_tpu_torch.scripts.video_sample, lfvdm_tpu_torch.scripts.video_train
import lfvdm_tpu_torch.data.native_loader, lfvdm_tpu_torch.training.vis_sampling
import lfvdm_tpu_torch.utils.paths, lfvdm_tpu_torch.utils.rng, lfvdm_tpu_torch.utils.video_io
import lfvdm_tpu_torch.evals.lpips, lfvdm_tpu_torch.scripts.video_optimal_schedule
import lfvdm_tpu_torch.evals.fvd, lfvdm_tpu_torch.evals.i3d, lfvdm_tpu_torch.evals.carla_regressor
import lfvdm_tpu_torch.scripts.video_fvd, lfvdm_tpu_torch.scripts.video_to_world_coords
import lfvdm_tpu_torch.scripts.video_make_mp4, lfvdm_tpu_torch.scripts.carla_regressor_train
import lfvdm_tpu_torch.serving, lfvdm_tpu_torch.utils.msgpack
import lfvdm_tpu_torch.scripts.export_sampler, lfvdm_tpu_torch.scripts.export_params
import lfvdm_tpu_torch.parallel, lfvdm_tpu_torch.parallel.mesh, lfvdm_tpu_torch.parallel.sharding
bad = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def test_latent_modules_import_with_jax_blocked():
    code = BLOCKER.format(blocked=FORBIDDEN)
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr
