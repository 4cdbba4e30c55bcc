"""The rollout kernel reduced and staged, on the card.

Port of ``experiments/rollout_bisect.py``: K2 cut down to one kernel whose
pieces a stage switches on one by one (the draws, the PSO loop with a
trivial cost, the 25-cell stencil bind, the full quadratic form; see
``ops/rollout_bisect.py``).  Runs one stage, or all 28, at the script's
shape (B=2 solves, P=256, N=256, 3 iterations) and prints
``"stage <s>: OK"``.  The script's inputs (seed 0) bind no point: its
anchors and bins lie too far apart for the 25-cell stencil, so the bind and
the score see only masked points.  ``--binding`` takes
:func:`binding_inputs` instead, where points bind and score; timed at K2's
batch shape, stages 1, 2 and 3 split K2's time into the draws and the
update, the bind, and the score.

    python -m ndtpso_slam_tpu_torch.experiments.rollout_bisect STAGE|all [--binding] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ndtpso_slam_tpu_torch.experiments import describe, log, parse_args, sync, time_ms
from ndtpso_slam_tpu_torch.ops.rollout_bisect import STAGES, rollout_bisect

B, P, N, R = 2, 256, 256, 2
K2 = (2 * R + 1) ** 2
ITERS = 3


def _tensors(device, keys, guesses, devs, pts, sten):
    return (torch.from_numpy(keys.astype(np.int64)).to(device),
            *(torch.from_numpy(a).to(device) for a in (guesses, devs, pts, sten)))


def inputs(device, b=B, n=N, seed=0):
    """The script's inputs (its run()): keys [B, 2], guesses 0, devs
    (0.2, 0.2, 0.05), sten [B, 25, 8, N] in U(0, 1), pts [B, 8, N] in
    U(-8, 8) — anchors and valid flags included."""
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32)
    guesses = np.zeros((b, 3), np.float32)
    devs = np.tile(np.float32([0.2, 0.2, 0.05]), (b, 1))
    sten = rs.uniform(0, 1, (b, K2, 8, n)).astype(np.float32)
    pts = rs.uniform(-8, 8, (b, 8, n)).astype(np.float32)
    return _tensors(device, keys, guesses, devs, pts, sten)


def binding_inputs(device, b=B, n=N, seed=0):
    """Inputs in the script's layout where points bind, shaped like a scan
    matched against its own map, so the zero pose is a sharp minimum.
    Points in U(-15, 15) m; anchors ``floor(p + 16)`` of each point, so at
    the zero guess every point lies in its stencil; half the points then
    moved by up to 2 cells, so every stencil offset is hit, and some points
    leave the stencil or the frame once a pose moves them.  Valid flags in
    {0, 1}, ~10% zeros.  Each stencil cell: its mean within 0.25 m of the
    cell centre, except that the cell a point lies in at the zero pose has
    its mean within 5 cm of the point; (la, lb, lc) positive definite, as a
    cell of 0.13-0.22 m spread has (la, lc in [20, 60], |lb| < 5); built in
    {0, 1}, ~80% built."""
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32)
    guesses = np.zeros((b, 3), np.float32)
    devs = np.tile(np.float32([0.2, 0.2, 0.05]), (b, 1))
    p0 = rs.uniform(-15, 15, (b, 2, n)).astype(np.float32)
    anchor = np.floor(p0 + np.float32(16.0))
    moved = rs.uniform(0, 1, (b, 1, n)) < 0.5
    p1 = (p0 + moved * rs.uniform(-2, 2, (b, 2, n))).astype(np.float32)
    pts = np.zeros((b, 8, n), np.float32)
    pts[:, 0:2] = p1
    pts[:, 2:4] = anchor
    pts[:, 4] = rs.uniform(0, 1, (b, n)) >= 0.1
    sten = np.zeros((b, K2, 8, n), np.float32)
    for k in range(K2):
        off = np.array([k % (2 * R + 1) - R, k // (2 * R + 1) - R], np.float32)[None, :, None]
        centre = anchor + off - np.float32(16.0) + np.float32(0.5)
        sten[:, k, 0:2] = centre + rs.uniform(-0.25, 0.25, (b, 2, n))
        sten[:, k, 2] = rs.uniform(20, 60, (b, n))
        sten[:, k, 3] = rs.uniform(-5, 5, (b, n))
        sten[:, k, 4] = rs.uniform(20, 60, (b, n))
        sten[:, k, 5] = rs.uniform(0, 1, (b, n)) < 0.8
    # The point's own cell at the zero pose: its stencil offset, mean at it.
    d = (np.floor(p1 + np.float32(16.0)) - anchor + R).astype(np.int64)  # [B, 2, N]
    own = d[:, 1] * (2 * R + 1) + d[:, 0]
    bi, ni = np.meshgrid(np.arange(b), np.arange(n), indexing="ij")
    sten[bi, own, 0:2, ni] = (p1 + rs.uniform(-0.05, 0.05, (b, 2, n))).transpose(0, 2, 1)
    return _tensors(device, keys, guesses, devs, pts, sten)


def run(device, stages=STAGES, b=B, p=P, n=N, iters=ITERS, binding=False, seed=0, reps=0):
    """Runs each stage once and then ``reps`` timed calls after a warm one
    (none for reps=0).  Returns {stage: (out [B, 8, 128], ms)}."""
    args = (binding_inputs if binding else inputs)(device, b, n, seed)
    res = {}
    for stage in stages:
        call = lambda: rollout_bisect(stage, *args, population=p, iterations=iters)
        out = call()
        sync(device)
        log(f"stage {stage}: OK")
        res[stage] = (out, time_ms(call, reps, device) if reps else None)
    return res


def _stage(value):
    return STAGES if value == "all" else (int(value),)


def main(argv=None):
    def add(ap):
        ap.add_argument("stage", type=_stage, help="0-27, or all")
        ap.add_argument("--binding", action="store_true",
                        help="inputs whose points bind (binding_inputs)")

    device, args = parse_args(__doc__.splitlines()[0], argv, add)
    log("device:", describe(device))
    run(device, args.stage, binding=args.binding)


if __name__ == "__main__":
    main()
