"""Variants of the fused scoring kernel at bench shapes, on the card.

Port of ``experiments/kernel_variants.py``: the same seeded inputs
(B=64 solves, N=384 points, P=4096 particles, 16 features), the same six
configurations, the max abs diff of each against v0, and its time over I=50
launches enqueued back to back on one stream (CUDA events), which serialises
them as the TPU script's ``phit + acc*0`` chain did:

  v0: f32 z on the FP32 pipes + mask reduction on the tensor cores (TF32)
  v1: bf16 z on the tensor cores + mask reduction on the tensor cores (bf16)
  v2: f32 z + mask reduction on the FP32 pipes
  v3: bf16 z + mask reduction on the FP32 pipes
  v3t, v0t: v3 and v0 with 4096 particles per block instead of 2048

    python -m ndtpso_slam_tpu_torch.experiments.kernel_variants [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ndtpso_slam_tpu_torch.experiments import describe, log, parse_device, time_ms
from ndtpso_slam_tpu_torch.ops import score_variants as sv

B, P, N, I = 64, 4096, 384, 50
FDIM = 16
TILE_P = 2048

# (name, z route, reduction, particles per block)
CONFIGS = [
    ("v0 f32 + matvec", "f32", "mma", TILE_P),
    ("v1 bf16 + matvec", "bf16", "mma", TILE_P),
    ("v2 f32 + vpu-sum", "f32", "cores", TILE_P),
    ("v3 bf16 + vpu-sum", "bf16", "cores", TILE_P),
    ("v3t bf16 + vpu-sum tile4096", "bf16", "cores", 4096),
    ("v0t f32 + matvec tile4096", "f32", "mma", 4096),
]


def inputs(device, b=B, p=P, n=N):
    """The TPU script's inputs (seed 0): phit [B, 16, P] in U(-1, 1),
    w [B, N, 16] in U(0, 1), mask [B, N] with 80% ones."""
    rs = np.random.RandomState(0)
    phit = rs.uniform(-1, 1, (b, FDIM, p)).astype(np.float32)
    w = rs.uniform(0, 1, (b, n, FDIM)).astype(np.float32)
    mask = (rs.uniform(0, 1, (b, n)) > 0.2).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (phit, w, mask))


def scores(phit, w, mask, zroute, reduce, tile):
    """One configuration's costs, [B, 1, P] as the TPU kernel returns them."""
    return sv.score_variants(phit, w, mask, zroute, reduce, tile)[:, None, :]


def run(device, b=B, p=P, n=N, iters=I):
    """The study: each configuration's output, its max abs diff against v0
    and its ms per launch.  Returns {name: (out, max diff vs v0, ms)}."""
    phit, w, mask = inputs(device, b, p, n)
    results = {}
    ref = None
    for name, zroute, reduce, tile in CONFIGS:
        fn = lambda: scores(phit, w, mask, zroute, reduce, tile)
        out = fn()
        diff = 0.0
        if ref is None:
            ref = out
        else:
            diff = (out - ref).abs().max().item()
            log(f"  {name}: max abs diff vs v0 {diff:.5f} "
                f"(rel {diff / ref.abs().max().item():.2e})")
        ms = time_ms(fn, iters, device, warm=False)
        log(f"{name}: {ms * iters:.3f} ms / {iters} launches = {ms * 1e3:.1f} us/launch")
        results[name] = (out, diff, ms)
    return results


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    log("device:", describe(device))
    run(device)


if __name__ == "__main__":
    main()
