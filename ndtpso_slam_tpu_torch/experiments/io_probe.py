"""Input-layout probes of the rollout kernel, on the card.

Port of ``experiments/io_probe.py``: four ways the rollout kernels' inputs
reach a kernel — the points [B, 8, N]; the keys as scalars beside them; the
25-cell stencil table [B, 25, 8, N]; its [B, 200, N] view — each a
per-(solve, row) sum over the N points, broadcast to [B, 8, 128].  Prints
``"<probe>: OK"`` for each probe it runs, at the script's shape (B=2,
N=256, seed 0); ``run`` also times them, and at C1's batch shape (B=256,
N=384) the stencil probes stream the 78.6 MB table the rollout kernels
read.

    python -m ndtpso_slam_tpu_torch.experiments.io_probe [min|smem|sten3|sten4|all] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ndtpso_slam_tpu_torch.experiments import describe, log, parse_args, sync, time_ms
from ndtpso_slam_tpu_torch.ops.probes import io_probe

B, P, N, K2 = 2, 256, 256, 25
# The script's order and printed names.
PROBES = {"min": "min 3D pts", "smem": "smem + grid", "sten3": "sten 3D", "sten4": "sten 4D"}
REPS = 10


def inputs(device, b=B, n=N, seed=0):
    """The script's inputs: keys [B, 2] u32 words (int64), sten4
    [B, 25, 8, N] in U(0, 1) and its view sten3 [B, 200, N], pts [B, 8, N]
    in U(-8, 8)."""
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32).astype(np.int64)
    sten4 = torch.from_numpy(rs.uniform(0, 1, (b, K2, 8, n)).astype(np.float32)).to(device)
    pts = rs.uniform(-8, 8, (b, 8, n)).astype(np.float32)
    return dict(keys=torch.from_numpy(keys).to(device), sten4=sten4,
                sten3=sten4.view(b, K2 * 8, n), pts=torch.from_numpy(pts).to(device))


def probe_args(name, inp):
    """The arguments of ``io_probe(name, ...)`` from :func:`inputs`."""
    return {"min": (inp["pts"],), "smem": (inp["pts"], inp["keys"]),
            "sten3": (inp["sten3"],), "sten4": (inp["sten4"],)}[name]


def run(device, which="all", b=B, n=N, seed=0, reps=REPS):
    """Runs the probes (all, or one), each once and then ``reps`` timed
    calls after a warm one (none for reps=0).  Returns {probe: (out, ms)}."""
    inp = inputs(device, b, n, seed)
    res = {}
    for name in (PROBES if which == "all" else (which,)):
        args = probe_args(name, inp)
        out = io_probe(name, *args)
        sync(device)
        log(f"{PROBES[name]}: OK")
        ms = time_ms(lambda: io_probe(name, *args), reps, device) if reps else None
        res[name] = (out, ms)
    return res


def main(argv=None):
    device, args = parse_args(__doc__.splitlines()[0], argv, lambda ap: ap.add_argument(
        "which", nargs="?", default="all", choices=[*PROBES, "all"]))
    log("device:", describe(device))
    run(device, args.which)


if __name__ == "__main__":
    main()
