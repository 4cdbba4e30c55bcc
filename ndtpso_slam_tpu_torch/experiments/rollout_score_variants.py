"""The rollout kernel's per-iteration score block variants, on the card.

Port of ``experiments/rollout_score_variants.py``: the (matmul -> exp ->
reduce) chain at bench shapes (B=64 solves, N=384 points, P=4096
particles) inside one kernel, one block per solve running I=50 serial
iterations, each tied to the last by a block-wide minimum (no overlap
across iterations), for the variants

  base:    z on the FP32 pipes, exp(-max(z, 0)/2)
  exp2:    exp2(-0.5 log2(e) max(z, 0))
  noclamp: exp(-z/2)
  bf16mm:  z on the tensor cores from bf16 operands, then base
  bf16all: bf16mm, then max(z, 0) in bf16, a bf16 product and a bf16 exp2

and, per variant, the time at I and at I/2 (it must scale with I).

    python -m ndtpso_slam_tpu_torch.experiments.rollout_score_variants [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ndtpso_slam_tpu_torch.experiments import describe, log, parse_device, time_ms
from ndtpso_slam_tpu_torch.ops import score_variants as sv

B, P, N, I = 64, 4096, 384, 50
FDIM = 16
VARIANTS = sv.BLOCK_VARIANTS
REPS = 3  # the TPU script's timing protocol: 3 calls after a drained one


def inputs(device, b=B, p=P, n=N):
    """The TPU script's inputs (seed 0): phit [B, 16, P] in U(-1, 1) and
    w [B, N, 16] in U(0, 1)."""
    rs = np.random.RandomState(0)
    phit = rs.uniform(-1, 1, (b, FDIM, p)).astype(np.float32)
    w = rs.uniform(0, 1, (b, n, FDIM)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (phit, w))


def run(device, b=B, p=P, n=N, iters=I):
    """The study.  Returns {variant: (carry, c, ms at I, ms at I/2)}."""
    phit, w = inputs(device, b, p, n)
    results = {}
    for name in VARIANTS:
        carry, c = sv.score_block(phit, w, iters, name)
        ms = time_ms(lambda: sv.score_block(phit, w, iters, name), REPS, device, warm=False)
        half = max(1, iters // 2)
        ms_half = time_ms(lambda: sv.score_block(phit, w, half, name), REPS, device)
        log(f"{name}: {ms:.2f} ms / {iters} iters = {ms / iters * 1e3:.1f} us/iter "
            f"({ms_half:.2f} ms at {half} iters)  (sum0={float(carry[0]):.3f})")
        results[name] = (carry, c, ms, ms_half)
    return results


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    log("device:", describe(device))
    run(device)


if __name__ == "__main__":
    main()
