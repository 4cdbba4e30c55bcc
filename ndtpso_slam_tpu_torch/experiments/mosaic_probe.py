"""Single-op probes of the rollout kernel, on the card.

Port of ``experiments/mosaic_probe.py``: the seven ops that bisected a
Mosaic crash — a per-row constant add, a (1, 1) select on a minimum, a
(1, 1) slice through cos, a five-step loop with small carries, Threefry-2x32,
a contraction over the 8 rows, a broadcast of row sums — each one kernel on
an [8, 512] tile.  Prints ``"<probe>: OK"`` for each, on the script's
inputs (all ones); ``run`` also times them, and takes seeded random inputs.

    python -m ndtpso_slam_tpu_torch.experiments.mosaic_probe [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ndtpso_slam_tpu_torch.experiments import describe, log, parse_device, sync, time_ms
from ndtpso_slam_tpu_torch.ops.probes import mosaic_probe

P = 512
N = 256
# The script's order and printed names.
PROBES = {
    "col3": "col3 iota-where (8,1) bool",
    "bool11": "(1,1) bool where",
    "slice11": "(1,1) f32 slice + cos",
    "fori_small": "fori small carries",
    "threefry": "threefry u32",
    "dotgen": "dot_general lhs-contract0",
    "bcast_out": "broadcast (8,1)->(8,P)",
}
REPS = 20


def inputs(device, p=P, seed=None):
    """(x f32 [8, P], xi u32 words [8, P] as int64): the script's ones, or
    for a seed x in U(-1, 1) and xi uniform over the u32 words."""
    if seed is None:
        x = np.ones((8, p), np.float32)
        xi = np.ones((8, p), np.int64)
    else:
        rs = np.random.RandomState(seed)
        x = rs.uniform(-1, 1, (8, p)).astype(np.float32)
        xi = rs.randint(0, 2**32, (8, p), dtype=np.int64)
    return torch.from_numpy(x).to(device), torch.from_numpy(xi).to(device)


def run(device, p=P, seed=None, reps=REPS):
    """Runs the seven probes, each once and then ``reps`` timed calls after
    a warm one (none for reps=0).  Returns {probe: (out, ms)}."""
    x, xi = inputs(device, p, seed)
    res = {}
    for name, label in PROBES.items():
        arg = xi if name == "threefry" else x
        out = mosaic_probe(name, arg, N)
        sync(device)
        log(f"{label}: OK")
        ms = time_ms(lambda: mosaic_probe(name, arg, N), reps, device) if reps else None
        res[name] = (out, ms)
    return res


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    log("device:", describe(device))
    run(device)


if __name__ == "__main__":
    main()
