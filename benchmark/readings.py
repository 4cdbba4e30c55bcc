"""The readings a cell's limits are set from, many seeds in one process.

    python3 benchmark/readings.py --workload batch_match.b16 --seeds 1,2,3 --seconds 4

For each seed: set-up and a short window of the cell as ``run.py`` makes
them, then the judge twice over what the window produced: once on the
program's answers (the lower reading of each number) and once on the
precision control's (the upper reading): the reference computed in
bfloat16 in the program's place (the node), or the program's own bf16
scoring path, ``control_mode``, on the same inputs (batch matching).  The
program's parted samples are looked at (``judge.py``'s witness).  One JSON
line per seed on standard output; a summary line last.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def quantiles(samples):
    """p50, p75, p90 and the maximum of each per-sample column."""
    import numpy as np

    cols = np.asarray([s[1:] for s in samples], dtype=np.float64).T
    return [[float(np.quantile(c, q)) for q in (0.5, 0.75, 0.9, 1.0)] for c in cols]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    import torch

    from ndtbench import cell as cellmod
    from ndtbench import drivers, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell = cellmod.load(args.workload)
    lows, highs = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = drivers.DRIVERS[cell.config["entry"]](cell, seed, args.seconds, False, dev, t0)
        p_j, c_j = run.judge(False, witness=True), run.judge(True)
        prog, ctrl = p_j["numbers"], c_j["numbers"]
        del run
        drivers.free(dev)
        print(json.dumps(harness._finite({
            "seed": seed, "program": prog, "control": ctrl,
            "program_quantiles": quantiles(p_j["samples"]),
            "control_quantiles": quantiles(c_j["samples"]),
            "witnesses": p_j["witnesses"],
            "seconds": time.perf_counter() - t0})), flush=True)
        for k, v in prog.items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in ctrl.items():
            highs[k] = min(highs.get(k, float("inf")), v)
    print(json.dumps(harness._finite({"workload": args.workload, "lower": lows, "upper": highs,
                                      "forbidden": harness.forbidden_modules()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
