"""The least time an H100 could take for a kernel's work.

A frozen copy of ``chip_smoke.py``'s bound arithmetic (``PEAK``, ``bound``,
``score_ops``, ``_evaluations``, ``ROLLOUT_LOCAL_FLOPS``,
``_rollout_local_bound``, ``_rollout_bound``, ``_score_bound``), so a change
to the program cannot move the yardstick.  The one change: the kernel
bounds take the shapes of the operands (B solves of N points, a (2r+1)²
stencil of 8 floats per lane and 8 floats per point, K3's features,
coefficients and mask, all float32) where the origin took the tensors.
``tests/test_bench_frozen.py`` holds the copy to the values the origin
gave when it was copied.
"""

from __future__ import annotations

# Peak rates of one H100 SXM at its 700 W limit: NVIDIA's data sheet (HBM,
# FP32 outside the tensor cores, dense TF32 and bf16 tensor cores) and, for
# exp/exp2, the special-function units: 16 lanes per SM (Hopper white paper)
# x 132 SMs x the 1.98 GHz clock that the 67 TFLOP/s FP32 figure implies.
HBM_BYTES_S = 3.35e12
# int32: the 64 INT32 lanes of each SM (Hopper white paper) at the same clock.
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "sfu": 132 * 16 * 1.98e9,
        "int32": 132 * 64 * 1.98e9}

# rollout_local's point evaluation (csrc/rollout_local.cu): the rigid
# transform (8), the cell binning (4), the residual (2), the quadratic form
# (9), -q/2 and the sum (2) on the FP32 pipes, one exp.
ROLLOUT_LOCAL_FLOPS = 25
# Floats per stencil lane and per point in the packed operands.
LANE_FLOATS = 8


def bound(nbytes, **ops):
    """The least time the card could take for the work: (ms, "bytes" or
    "operations"), the larger of nbytes over the HBM rate and, over the
    pipes named in ops (fp32, tf32, bf16, sfu, int32), the slowest pipe's
    operations over its peak."""
    t_ops = max((v / PEAK[k] for k, v in ops.items()), default=0.0)
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def score_ops(pairs, features, zpipe="fp32", rpipe="fp32", masked=True):
    """Operations of the frozen score over `pairs` (point, particle) pairs:
    the contraction (2 per feature) on zpipe, -z/2 and max(z, 0) on the
    FP32 pipes, the point sum (a multiply and an add per pair with a mask,
    an add without) on rpipe, one exp per pair on the special-function
    units."""
    ops = {"fp32": 2.0 * pairs, "sfu": float(pairs)}
    ops[zpipe] = ops.get(zpipe, 0.0) + 2.0 * features * pairs
    ops[rpipe] = ops.get(rpipe, 0.0) + (2.0 if masked else 1.0) * pairs
    return ops


def evaluations(population, live_iterations):
    """Particle evaluations of whole solves: the gbest seed, the population,
    and the population again in each iteration a solve ran."""
    return sum(1 + population * (1 + int(i)) for i in live_iterations)


def packed_bytes(batch, n_pts, radius=2):
    """Bytes of the packed stencil [B, K2, N, 8] and points [B, N, 8]."""
    k2 = (2 * radius + 1) ** 2
    return 4.0 * batch * n_pts * LANE_FLOATS * (k2 + 1)


def rollout_local_bound(batch, n_pts, population, live_iterations):
    """K1's bound: each evaluation scores the N points with the exact
    stencil cost."""
    pairs = evaluations(population, live_iterations) * n_pts
    return bound(packed_bytes(batch, n_pts), fp32=ROLLOUT_LOCAL_FLOPS * pairs, sfu=pairs)


def rollout_bound(batch, n_pts, population, live_iterations, score_dtype="f32"):
    """K2's bound: each evaluation scores the N points (15 features); bf16
    operands contract on the tensor cores."""
    pairs = evaluations(population, live_iterations) * n_pts
    zpipe = "bf16" if score_dtype == "bf16" else "fp32"
    return bound(packed_bytes(batch, n_pts), **score_ops(pairs, 15, zpipe, masked=False))


def score_bound(batch, n_pts, population, features=15):
    """K3's bound for one launch (``csrc/score.cu``): the transposed
    features [B, F, P], the coefficients [B, N, F] and the mask [B, N] read
    and the costs [B, P] written, all float32; every (point, particle) pair
    scored on the FP32 pipes with its mask."""
    nbytes = 4.0 * (batch * features * population + batch * n_pts * features + batch * n_pts
                    + batch * population)
    return bound(nbytes, **score_ops(batch * population * n_pts, features))
