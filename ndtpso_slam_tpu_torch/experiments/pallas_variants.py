"""Fused scoring variants inside the full batched PSO loop, on the card.

Port of ``experiments/pallas_variants.py``: B=32 solves of P=4096 particles
and I=50 iterations (``models/pso.py:pso_solve_batch``) against one world,
a 64 m map of 1 m cells with 4 slots built by three add+build passes of a
noisy 10 m x 8 m ellipse of N=384 points, with the ellipse itself as every
solve's scan (so the right answer is the pose 0).  The cost of each solve
binds its points (``models/cost.py:bind_points``), forms the pose features
and scores them with one variant of ``ops/score_variants.py``:

  dot_dot:    z on the tensor cores (TF32) + mask reduction on the tensor cores (TF32)
  dot_vpusum: z on the tensor cores (TF32) + mask reduction on the FP32 pipes
  vpu_outer:  z by the feature-outer loop on the FP32 pipes + reduction there

at 256, 512 and 1024 particles per block, beside ``xla_baseline``, the
plain PyTorch chain (``models/cost.py:bound_cost``, full float32).  Per
variant: ms per batch and solves/s over 6 calls after a warm one (host
clock, one synchronise), the cost's max diff against the baseline, and the
median pose error.

    python -m ndtpso_slam_tpu_torch.experiments.pallas_variants [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ndtpso_slam_tpu_torch import config as C
from ndtpso_slam_tpu_torch.experiments import describe, log, parse_device, sync
from ndtpso_slam_tpu_torch.models import cost, ndt_map
from ndtpso_slam_tpu_torch.models.pso import pso_solve_batch
from ndtpso_slam_tpu_torch.ops import score_variants as sv

B, P, N, F = 32, 4096, 384, 16
ITERS = 50
REPS = 6
VARIANTS = {"dot_dot": ("tf32", "mma"), "dot_vpusum": ("tf32", "cores"),
            "vpu_outer": ("outer", "cores")}
TILES = (256, 512, 1024)
BASELINE = "xla_baseline"


def world(device, b=B, n=N, population=P, iterations=ITERS):
    """The TPU script's world and batch (seed 0), the map built on the CPU
    (where the port's map is bit-equal to the JAX package's) and moved to
    ``device``."""
    map_cfg = C.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=4)
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = (np.stack([10 * np.cos(t), 8 * np.sin(t)], -1)
           + rs.normal(0, 0.05, (n, 2))).astype(np.float32)
    st = ndt_map.init_map(map_cfg, device="cpu")
    for _ in range(3):
        noisy = pts + rs.normal(0, 0.03, pts.shape).astype(np.float32)
        ndt_map.add_points(st, map_cfg, torch.from_numpy(noisy), torch.ones(n, dtype=torch.bool))
        ndt_map.build(st, map_cfg)
    snap = ndt_map.snapshot(st, map_cfg)
    snaps = ndt_map.MapSnapshot(*(x[None].expand(b, *x.shape).contiguous().to(device)
                                  for x in (snap.mean, snap.inv_cov, snap.built)))
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32).astype(np.int64)
    return dict(
        map_cfg=map_cfg, pso_cfg=C.PSOConfig(iterations=iterations, population=population),
        snaps=snaps, points=torch.from_numpy(pts)[None].expand(b, n, 2).contiguous().to(device),
        valid=torch.ones((b, n), dtype=torch.bool, device=device),
        keys=torch.from_numpy(keys).to(device),
        guesses=torch.zeros((b, 3), device=device),
        devs=torch.tensor([[0.3, 0.3, 0.05]] * b, device=device),
    )


def _bind(wd, binds):
    return cost.bind_points(binds, wd["snaps"], wd["points"], wd["valid"], wd["map_cfg"])


def variant_cost(wd, zroute, reduce, tile):
    """The batched cost (poses [B, P, 3], binds [B, 3]) -> [B, P] of one
    scoring variant."""
    def cost_fn(poses, binds):
        bound = _bind(wd, binds)
        phit = cost.pose_features_t(poses, bound.bind_pose)  # [B, 15, P]
        return sv.score_variants(phit, bound.w, bound.mask, zroute, reduce, tile)
    return cost_fn


def baseline_cost(wd):
    """The plain chain: z = φ·wᵀ, exp, mask sum (``cost.bound_cost``)."""
    return lambda poses, binds: cost.bound_cost(poses, _bind(wd, binds))


def solvers(wd):
    """{name: cost function}: the baseline, then every variant and tile."""
    out = {BASELINE: baseline_cost(wd)}
    for name, (zroute, reduce) in VARIANTS.items():
        for tile in TILES:
            out[f"{name}_t{tile}"] = variant_cost(wd, zroute, reduce, tile)
    return out


def solve(wd, cost_fn):
    return pso_solve_batch(wd["keys"], wd["guesses"], wd["devs"], cost_fn, wd["pso_cfg"])


def run(device, b=B, n=N, population=P, iterations=ITERS, reps=REPS):
    """The study.  Returns {name: dict(ms, solves_s, maxdiff, med_xy, med_th,
    pose, cost)}."""
    wd = world(device, b, n, population, iterations)
    fns = solvers(wd)
    warm = {name: solve(wd, fn) for name, fn in fns.items()}
    sync(device)
    log("drained")
    base = warm[BASELINE].cost
    results = {}
    for name, fn in fns.items():
        solve(wd, fn)
        sync(device)
        t0 = time.perf_counter()
        outs = [solve(wd, fn) for _ in range(reps)]
        sync(device)
        total = time.perf_counter() - t0
        res = outs[-1]
        maxdiff = (res.cost - base).abs().max().item()
        err = res.pose.abs().cpu().numpy()
        med_xy, med_th = float(np.median(err[:, :2])), float(np.median(err[:, 2]))
        log(f"{name}: {total / reps * 1e3:.1f} ms/batch -> {b * reps / total:.0f} solves/s "
            f"(cost maxdiff {maxdiff:.1e}; median |xy| {med_xy:.4f} m, |th| {med_th:.5f} rad)")
        results[name] = dict(ms=total / reps * 1e3, solves_s=b * reps / total, maxdiff=maxdiff,
                             med_xy=med_xy, med_th=med_th, pose=res.pose, cost=res.cost)
    return results


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    torch.backends.cuda.matmul.allow_tf32 = False  # the baseline in full float32
    log("device:", describe(device))
    run(device)


if __name__ == "__main__":
    main()
