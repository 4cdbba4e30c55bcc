"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload scan_launch.patrol --seed 7 --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cell's CUDA devices.
With ``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics from a short traced window.  The
last line of standard output is the result as JSON; the last lines of
standard error are the numbers that decide ``correct``, each beside its
limit.  Exits non-zero without a result when the devices are missing, the
program cannot be imported, or a JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
# Kernel caches of any library the program may reach stay in the checkout,
# at fixed paths (the program's own libraries build into its _build/).
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be a non-negative whole number", file=sys.stderr)
        return 2

    import json

    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3

    from ndtbench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0, chips=chips)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded JAX modules: {', '.join(found)}", file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
