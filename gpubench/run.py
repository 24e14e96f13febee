"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload flagship.sample --seed 7 --seconds 30 --trace 0

From the root of a checkout on a machine with the cards the cell asks for.
Set-up (the port's kernels built into ``lfvdm_tpu_torch/ops/_build/`` on a
checkout's first run, the model made from the seed, the cell's shapes
warmed up), then ``--seconds`` of measured work, then the check of what the
window produced against the plain reference. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then ``checks``:
each number compared with its limit); the checks are also the last lines
of standard error. Exits non-zero, printing no result, without enough CUDA
devices, without the port beside this directory, or when JAX or the JAX
package was imported.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Build and kernel caches at fixed paths inside the checkout.
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(HERE / "_cache" / _dir)
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from harness import forbidden_modules, load_cell, result_line, run_cell

    cell = load_cell(args.workload)
    if importlib.util.find_spec("lfvdm_tpu_torch") is None:
        print(f"{args.workload} measures lfvdm_tpu_torch, which is not beside {HERE}",
              file=sys.stderr)
        return 4
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"the process imported {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    line = result_line(run, cell["chips"])
    print(f"gpubench {args.workload}: setup {run.setup_s:.2f} s, window "
          f"{run.window_seconds():.2f} s, {len(run.units)} units, check {run.check_s:.2f} s, "
          f"total {time.perf_counter() - T_PROCESS:.2f} s", file=sys.stderr)
    if run.trace_ops:
        from yardstick import kernel_group

        groups = {}
        for name, (seconds, _) in run.trace_ops.items():
            groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + seconds
        print("gpubench device seconds by group: " + ", ".join(
            f"{g} {s:.4f}" for g, s in sorted(groups.items(), key=lambda kv: -kv[1])),
            file=sys.stderr)
    ends = [run.t_window] + [u[0] for u in run.units]
    print("gpubench unit seconds: " + " ".join(f"{b - a:.4f}" for a, b in zip(ends, ends[1:])),
          file=sys.stderr)
    for name, spans in run.spans.items():
        dts = [dt for _, dt in spans]
        print(f"gpubench span {name}: {len(dts)} x, {sum(dts):.4f} s, min {min(dts):.4f}, "
              f"max {max(dts):.4f}", file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
