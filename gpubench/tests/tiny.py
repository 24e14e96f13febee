"""Tiny cells for the CPU tests: a copy of the benchmark beside a
``BENCHMARK.json`` of its own, with tiny configurations, traffic mixes and
limits added as files (the way a later change adds a cell), run on the CPU
through the harness with the port's plain paths."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

GPUBENCH = Path(__file__).resolve().parents[1]

TINY_CONFIG = {"image_size": 32, "in_channels": 3, "num_channels": 32, "num_res_blocks": 1,
               "num_heads": 4, "attention_resolutions": "8", "diffusion_steps": 8,
               "noise_schedule": "cosine", "rescale_timesteps": True,
               "compute_dtype": "float32", "diffusion_space": "pixel", "pre_encoded": False}
TINY_LATENT = dict(TINY_CONFIG, in_channels=4, diffusion_space="latent", pre_encoded=True,
                   vae={"block_out_channels": [32, 32], "layers_per_block": 1,
                        "latent_channels": 4})
TRAFFIC = {
    "tiny_video": {"entry": "sample_video", "batch_size": 2, "max_frames": 6,
                   "scheme": "hierarchy-2", "video_length": 16, "n_obs": 4, "step_size": 3,
                   "respacing": "ddim8", "compare_windows": 2, "compare_frames": 0,
                   "reference_rows": 2, "trace_units": 1, "warmup_seconds": 0},
    "tiny_latent_video": {"entry": "sample_video", "batch_size": 2, "max_frames": 4,
                          "scheme": "autoreg", "video_length": 8, "n_obs": 3, "step_size": 2,
                          "respacing": "ddim8", "compare_windows": 2, "compare_frames": 4,
                          "reference_rows": 2, "trace_units": 1, "warmup_seconds": 0},
    "tiny_train": {"entry": "train", "dataset": "carla_no_traffic",
                   "data_dir": "datasets/carla/no-traffic", "videos": 4, "video_length": 12,
                   "image_size": 32, "batch_size": 2, "max_frames": 5, "lr": 1e-4,
                   "ema_rate": "0.9999", "log_interval": 10, "warmup_steps": 4,
                   "trace_units": 2, "settle_units": 1, "warmup_seconds": 0},
}
# The tiny cells take the real cells' limits.
CELLS = {"tiny.video": ("tiny", "tiny_video", "flagship.sample"),
         "tiny.latent_video": ("tiny_latent", "tiny_latent_video", "latent.sample"),
         "tiny.train": ("tiny", "tiny_train", "flagship.train")}


def tiny_benchmark(root: Path) -> Path:
    """``root/gpubench``: the benchmark with the tiny cells added as files,
    and ``root/BENCHMARK.json`` naming them beside the real ones."""
    shutil.copytree(GPUBENCH, root / "gpubench", ignore=shutil.ignore_patterns(
        "__pycache__", "_cache", "tests"))
    bench = json.loads((GPUBENCH.parent / "BENCHMARK.json").read_text())
    for name, cfg in (("tiny", TINY_CONFIG), ("tiny_latent", TINY_LATENT)):
        (root / "gpubench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                                 "file": f"gpubench/configs/{name}.json"})
    for name, traffic in TRAFFIC.items():
        (root / "gpubench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell, (config, traffic, like) in CELLS.items():
        shutil.copy(GPUBENCH / "limits" / f"{like}.json",
                    root / "gpubench" / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "test"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root / "gpubench"


def run_tiny(gpubench: Path, cell: str, seed: int = 11, seconds: float = 2.0, control=False,
             device="cpu", trace=False):
    """Run ``cell`` on ``device`` through ``gpubench``'s harness; returns the
    run record (its entry's ``check`` with ``control`` too) and whether it
    came out correct."""
    import importlib.util
    import sys

    for p in (str(GPUBENCH.parent), str(gpubench)):
        if p not in sys.path:
            sys.path.insert(0, p)
    spec = importlib.util.spec_from_file_location("gpubench_harness", gpubench / "harness.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    loaded = harness.load_cell(cell, root=gpubench.parent)
    entry = harness._load(gpubench / "entries" / f"{loaded['traffic']['entry']}.py",
                          f"tiny_entry_{loaded['traffic']['entry']}")
    run = harness.Run(loaded, seed, seconds, trace, device, time.perf_counter())
    kept = entry.run(run)
    run.reduce_trace()
    entry.check(run, kept, control=control)
    return run, harness.is_correct(run)
