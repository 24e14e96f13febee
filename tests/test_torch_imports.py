"""The PyTorch port imports neither JAX nor the JAX package.

An AST scan of every module of ``lfvdm_tpu_torch`` and of ``chip_smoke.py``
(which runs on a machine without JAX) for ``import`` statements naming
``jax``, ``flax`` or ``lfvdm_tpu``.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "lfvdm_tpu")
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
                     "chip_smoke.py"):
        assert expected in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_only_the_jax_side():
    assert _forbidden("jax.numpy") and _forbidden("flax.linen") and _forbidden("lfvdm_tpu.ops")
    assert not _forbidden("lfvdm_tpu_torch.ops") and not _forbidden("torch")
