"""The readings a cell's limits are set from, many seeds in one process.

    python3 benchmark/readings.py --workload batch_match.b16 --seeds 1,2,3 --seconds 4
    python3 benchmark/readings.py --workload scan_launch.patrol --seeds 1,2 \
        --overrides overrides.json

``--overrides`` names a JSON file, {"config": {...}, "traffic": {...}},
merged into the cell's files (``cell.load``), so a cell not yet in
``BENCHMARK.json`` can be read from an existing one.

For each seed: set-up and a short window of the cell as ``run.py`` makes
them, then the judge twice over what the window produced: once on the
program's answers (the lower reading of each number) and once on the
precision control's (the upper reading): the reference computed in
bfloat16 in the program's place (the node), or the program's own bf16
scoring path, ``control_mode``, on the same inputs (batch matching).  The
program's parted samples are looked at (``judge.py``'s witness).  For a
node with recovery on, each line also gives the run's kidnaps and accepted
relocalizations (:func:`event_report`).  One JSON line per seed on
standard output; a summary line last.
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


def event_report(run, every: int) -> dict:
    """A recovery node's window: its kidnaps and accepted relocalizations,
    those accepted at the kidnap step itself, those accepted again within
    the ``every`` steps after a kidnap, the host time of the timed window's
    kidnap steps and of its other steps (ms), the card's time per scan (ms,
    CUPTI) and the memory peak (bytes)."""
    import numpy as np

    ev = run.events
    kid, acc = ev["kidnaps"], set(ev["accepted"])
    after = [sum(1 for t in range(k + 1, k + every) if t in acc) for k in kid]
    lo = ev["timed_from"]
    ms = 1e3 * np.asarray(run.durations)
    on = np.zeros(len(ms), bool)
    on[[k - lo for k in kid if 0 <= k - lo < len(ms)]] = True
    q = lambda x: [float(np.quantile(x, v)) for v in (0.5, 0.95, 1.0)] if len(x) else None
    return {"kidnaps": len(kid), "accepted": len(acc),
            "accepted_at_kidnap": sum(1 for k in kid if k in acc),
            "accepted_after_kidnap": after,
            "kidnap_step_ms_p50_p95_max": q(ms[on]), "other_step_ms_p50_p95_max": q(ms[~on]),
            "card_ms_per_scan": (1e3 * run.card_busy_s / run.attempted
                                 if run.card_busy_s is not None else None),
            "memory_peak_bytes": run.memory_peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--overrides", help="a JSON file merged into the cell's files")
    args = ap.parse_args(argv)

    import torch

    from ndtbench import cell as cellmod
    from ndtbench import drivers, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)  # the allocator, whose peak each seed resets
    over = json.loads(Path(args.overrides).read_text()) if args.overrides else None
    cell = cellmod.load(args.workload, overrides=over)
    lows, highs = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        run = drivers.DRIVERS[cell.config["entry"]](cell, seed, args.seconds, False, dev, t0)
        t1 = time.perf_counter()
        p_j = run.judge(False, witness=True)
        t2 = time.perf_counter()
        c_j = run.judge(True)
        prog, ctrl = p_j["numbers"], c_j["numbers"]
        events = (event_report(run, int(cell.traffic.get("kidnap_every", 0)))
                  if run.events and p_j.get("event_samples") else None)
        del run
        drivers.free(dev)
        print(json.dumps(harness._finite({
            "seed": seed, "program": prog, "control": ctrl,
            "program_reported": p_j.get("reported"), "control_reported": c_j.get("reported"),
            "program_quantiles": quantiles(p_j["samples"]),
            "control_quantiles": quantiles(c_j["samples"]),
            "events": events, "program_event_samples": p_j.get("event_samples"),
            "control_event_samples": c_j.get("event_samples"),
            "witnesses": p_j["witnesses"], "judge_s": t2 - t1,
            "control_judge_s": time.perf_counter() - t2,
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
