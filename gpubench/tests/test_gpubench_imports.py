"""The reference imports neither JAX nor the JAX package nor the port, and
a run of each cell imports neither JAX nor the JAX package. Module names
are compared by their top-level name, whole: the port's name begins with
the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

GPUBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN_IN_REFERENCE = {"jax", "jaxlib", "flax", "lfvdm_tpu", "lfvdm_tpu_torch"}


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_jax_or_the_program():
    files = sorted((GPUBENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        assert not _top_level_imports(path) & FORBIDDEN_IN_REFERENCE, path.name


def test_top_level_names_compared_whole():
    sys.path.insert(0, str(GPUBENCH))
    from harness import FORBIDDEN

    assert "lfvdm_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "lfvdm_tpu" in FORBIDDEN


REHEARSAL = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, {tests!r})
import tiny
gpubench = tiny.tiny_benchmark(Path({root!r}))
out = {{}}
for cell in tiny.CELLS:
    run, correct = tiny.run_tiny(gpubench, cell, seconds=1.0)
    out[cell] = dict(correct=correct, units=len(run.units), failed=run.failed,
                     checks={{k: v for k, (v, _) in run.checks.items()}})
out["modules"] = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "lfvdm_tpu", "lfvdm_tpu_torch"}})
print(json.dumps(out))
"""


def test_cpu_rehearsal_of_each_cell_added_from_files(tmp_path):
    """Each entry runs end to end on the CPU in a tiny cell that was added
    to a copy of the benchmark as files alone (a configuration, a traffic
    mix, limits and ``BENCHMARK.json`` entries), comes out correct, and
    imports the port but neither JAX nor the JAX package."""
    code = REHEARSAL.format(tests=str(GPUBENCH / "tests"), root=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                                            "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("modules") == ["lfvdm_tpu_torch"]
    for cell, row in out.items():
        assert row["correct"] and row["units"] >= 1 and row["failed"] == 0, (cell, row)
