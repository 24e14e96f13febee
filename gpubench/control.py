"""The control of a cell's correctness check, on the card: for each seed, a
short window of the cell at its own sizes and load (one unit of work),
then the check of the program's output against the reference, and the same
numbers for the control in the program's place: the reference computed a
precision below the configuration's (the U-Net's convolutions and linear
layers in float8 e4m3 for its bfloat16 torso, the VAE decoder in bfloat16
for its float32; training also with half of each batch left out). The
benchmark's runs never run it; it sets the upper readings of the limits.

    python3 gpubench/control.py --workload flagship.sample --seeds 2147483659,2147483693

Prints one JSON line per seed: the program's numbers and the control's.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=0.0,
                        help="window length (0: one unit of work)")
    args = parser.parse_args(argv)

    import torch

    from harness import Run, _load, load_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    entry = _load(HERE / "entries" / f"{cell['traffic']['entry']}.py", "gpubench_control_entry")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(cell, seed, args.seconds, False, "cuda", time.perf_counter())
        kept = entry.run(run)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        entry.check(run, kept, control=True)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "units": len(run.units),
                          "program": {k: v for k, (v, _) in run.checks.items()},
                          "control": run.control, "check_s": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
