"""The harness's card-only paths (the trace, its reduction to per-layer
metrics and the result line) on tiny cells. Marked ``cuda``: skips without
a CUDA device. On a machine with a card:

    python -m pytest -p no:cacheprovider gpubench/tests/test_gpubench_card.py
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpubench(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tiny.tiny_benchmark(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.video", "tiny.latent_video", "tiny.train"])
def test_traced_run_reads_its_per_layer_metrics(gpubench, cell):
    run, correct = tiny.run_tiny(gpubench, cell, seconds=3.0, device="cuda", trace=True)
    assert correct, run.checks
    import harness  # the copy's, on the path run_tiny set

    line = harness.result_line(run, 1)
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"]
    for name, metric in line["metrics"].items():
        if name.startswith(("kernel_roofline", "update_roofline", "mfu")):
            assert 0 < metric["value"] <= 105, (name, metric)
