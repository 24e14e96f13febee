"""``port_spans.py``: the port's per-layer numbers read from a hand-filled
recorder, None where the port has no recorder or nothing was recorded;
the idle gaps split by the port's ranges on a synthetic trace; and the
tiny cells run on the CPU with the recorder on."""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import port_spans  # noqa: E402
import tiny  # noqa: E402
from harness import Run  # noqa: E402
from lfvdm_tpu_torch.utils import tracing  # noqa: E402
from lfvdm_tpu_torch.utils.tracing import Count, Span  # noqa: E402

MS = 1_000_000  # ns


def _run():
    run = Run({"traffic": {}}, 0, 2.0, False, "cpu", 0.0)
    run.t_window, run.t_untraced, run.t_end = 1.0, 2.0, 4.0
    return run


def _span(name, start_s, ms, thread=1):
    return Span(name, int(start_s * 1e9), int(start_s * 1e9) + int(ms * MS), thread, -1)


@pytest.fixture
def recorded(monkeypatch):
    """A recorder holding two windows and four loader batches in the
    untraced stretch [2, 4] s, and a capture and a gather before it."""
    spans = [_span("driver.gather", 1.5, 7), _span("graph.capture", 1.2, 30)]
    counts = [Count("graph.captures", int(1.2e9), 1)]
    for w in (2.1, 3.1):
        spans += [_span("driver.plan", w, 10), _span("driver.gather", w + 0.01, 5),
                  _span("window.steps", w + 0.02, 100), _span("driver.upload", w + 0.015, 1),
                  _span("driver.download", w + 0.13, 4), _span("driver.scatter", w + 0.14, 5)]
    for b in range(4):
        t = 2.0 + 0.45 * b
        spans += [_span("loader.read", t, 50, 2), _span("loader.normalize", t + 0.05, 400, 2)]
        counts += [Count("loader.batches", int(t * 1e9) + 1, 1),
                   Count("loader.frames", int(t * 1e9) + 1, 2 * 1000)]
    counts += [Count("train.frames", int(3e9), 40), Count("train.frames", int(3.5e9), 40)]
    spans.append(Span("loader.read", int(3.9e9), None, 2, -1))  # still open: left out
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counts", lambda: list(counts))


def test_per_layer_reads_the_recorder(recorded):
    got = port_spans.per_layer(_run())
    assert got["driver_gather_scatter_ms_per_window"] == pytest.approx(20.0)
    assert got["driver_transfer_ms_per_window"] == pytest.approx(5.0)
    assert got["loader_read_ms_per_batch"] == pytest.approx(50.0)
    assert got["loader_normalize_ms_per_batch"] == pytest.approx(400.0)
    assert got["loader_frames_used_share"] == pytest.approx(1.0)
    assert got["graph_captures"] == 1


def test_coverage_of_the_outside_measures(recorded):
    run = _run()
    # The benchmark's window spans around each window's upload and steps.
    run.spans["window"] = [(w + 0.012, 0.11) for w in (2.1, 3.1)]
    got = port_spans.coverage(run)
    host = 1e3 * (2.0 - 0.22) / 2
    assert got["driver_host_ms_per_window"] == pytest.approx(host)
    assert got["driver_outside_ms_per_window"] == pytest.approx(24.0)  # the upload is inside
    assert got["driver_outside_share"] == pytest.approx(100 * 24.0 / host)
    assert got["loader_busy_share"] == pytest.approx(100 * 4 * 0.45 / 2.0)
    assert got["loader_put_wait_share"] == 0


def test_nothing_to_read_reads_none(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counts", lambda: [])
    assert set(port_spans.per_layer(_run()).values()) == {None}
    # A port older than the recorder.
    import lfvdm_tpu_torch.utils

    monkeypatch.delattr(lfvdm_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "lfvdm_tpu_torch.utils.tracing", None)
    assert set(port_spans.per_layer(_run()).values()) == {None}
    assert port_spans.coverage(_run()) == {} and port_spans.span_totals(_run()) == {}


def test_idle_gaps_go_to_the_main_threads_innermost_range():
    main, loader = 1, 2
    events = [
        ("kernel", True, False, 0, 0, 10),
        ("gpubench.window", False, True, main, 5, 100),
        ("gpubench.window", True, True, 0, 5, 100),  # its copy on the device's timeline
        ("lfvdm.window.load", False, True, main, 12, 20),
        ("lfvdm.window.load", True, True, 0, 12, 20),  # its device-side copy takes no gap
        ("kernel", True, False, 0, 20, 30),
        ("lfvdm.loader.read", False, True, loader, 31, 60),  # another thread's
        ("kernel", True, False, 0, 60, 100),
        ("kernel", True, False, 0, 110, 120),
    ]
    gaps = port_spans.split_gaps(events)
    assert gaps == pytest.approx({"lfvdm.window.load": 10e-6, "window": 30e-6,
                                  "other": 10e-6})


@pytest.fixture(scope="module")
def gpubench(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.tiny_benchmark(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.video", "tiny.latent_video", "tiny.train"])
def test_tiny_cells_read_their_port_numbers(gpubench, cell):
    tracing.reset()
    tracing.enable()
    try:
        run, correct = tiny.run_tiny(gpubench, cell, seconds=1.0)
    finally:
        tracing.disable()
    assert correct, run.checks
    got = port_spans.per_layer(run)
    assert got["graph_captures"] == 0
    if cell == "tiny.train":
        tr = run.cell["traffic"]
        assert got["loader_read_ms_per_batch"] > 0 and got["loader_normalize_ms_per_batch"] > 0
        assert 0 < got["loader_frames_used_share"] <= 100 * tr["max_frames"] / tr["video_length"]
        cover = port_spans.coverage(run)
        assert 0 < cover["loader_busy_share"] + cover["loader_put_wait_share"] <= 100.0 + 1e-6
    else:
        assert got["driver_gather_scatter_ms_per_window"] > 0
        assert got["driver_transfer_ms_per_window"] > 0
        cover = port_spans.coverage(run)
        assert 0 < cover["driver_outside_share"] <= 100
