"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device and build: requires a CUDA device, prints the card's name and power
   limit (nvidia-smi), builds the seven kernel libraries from csrc/ (one nvcc
   each, all at once) and prints what ptxas reports of each kernel.
2. Kernel against its plain PyTorch version: B=3 solves, N=384 points,
   P in {50, 200}, 10 iterations, on a small synthetic map.
3. Kernel path against the plain path: 8 scans of SlamNode with
   cost_mode="rollout_local" and again with "local_exact".
4. Main path at scan.launch scale: a 300 m frame of 0.5 m cells (360,000
   cells), 100-slot window, 50 particles x 30 iterations, 384 padded beams,
   over the 50-scan synthetic log of bench.py's SLAM workload; the per-robot
   trajectory gate of bench.py (mean error < 0.35 m, max < 0.7 m) and the
   kernel's launch count; then the kernel against its plain version, both
   timed, on the inputs of the solve that run would make next.
5. Batch scan matching (parallel/mesh.py:solve_batch), bench.py's ``batch``
   workload:
   a. each kernel against its plain version on small inputs: the frozen
      rollout kernel in rollout, rollout_bf16 and rollout_turbo at B=3,
      N=384, P in {50, 200, 4096}, I=10, and with early exit 2; the turbo
      branch of the exact rollout kernel at B=3, P=50; the scoring kernel at
      B=4, P=4096, N=384 on binds of the 5b workload;
   b. solve_batch at full width (B=256 solves of a 64 m map of 1 m cells,
      P=4096, I=50, 360 beams padded to 384) in rollout, rollout_turbo
      (early exit 2) and fast_fused: bench.py's accuracy gate (median xy
      error < 0.05 m, median theta < 0.01 rad), solves/s under bench.py's
      protocol, the launch counts the path must make, each kernel against
      its plain version on the call's own inputs (every solve, phase 5a's
      tolerances; timed with CUDA events), and one profiled call (kernel
      launches, device busy share);
   c. rollout_bf16, rollout_turbo_bf16, fast_local_fused and
      rollout_local_turbo at B=16, the same widths: finite results, launch
      counts, and the two kernels not yet timed, against their plain
      versions as in 5b.
6. The variant studies ported from the TPU (ndtpso_slam_tpu_torch/experiments/),
   each driven once through the run() its entry point calls, at the TPU
   script's shapes, with the launch counts set to 0 just before and read
   just after; then every variant's kernel output held against its plain
   version, timed, and its bound:
   a. kernel_variants: the six scoring configurations, B=64, N=384, P=4096;
   b. rollout_score_variants: the five score-block variants, B=64, I=50,
      c and carry, and their time at I and I/2;
   c. pallas_variants: the nine variant/tile pairs inside pso_solve_batch
      at B=32, P=4096, I=50, beside the plain baseline (solves/s, cost
      maxdiff, median pose error; a variant less accurate than the
      baseline is printed as a finding), each kernel on the population
      call's own inputs against its plain version and float64;
   d. scatter_unique_ab: the row scatter at W=2 over 2.88 M rows and at
      W=128 over 360,001 rows, bit-equal to index_copy_ on unique ids and
      to its plain version on duplicate ids, beside the library calls;
   e. io_probe: the four input-layout probes at the script's shape (B=2,
      N=256) and at C1's batch shape (B=256, N=384: a 78.6 MB stencil
      table), beside torch.sum over the same tensor;
   f. mosaic_probe: the seven single-op probes on the script's [8, 512]
      tile of ones and on a seeded random tile, Threefry bit-equal, beside
      the one PyTorch call that computes col3, dotgen and bcast_out;
   g. rollout_bisect: every stage of the staged rollout kernel at the
      script's shape, on its inputs and on inputs whose points bind, then
      stages 1, 2 and 3 at K2's batch shape (B=256, P=4096, N=384, I=50):
      the draws and the update, the bind and the score as differences of
      their times, beside K2's time from phase 5b; at that shape, stage 3
      with no PSO step held to one evaluation's sum order on the binding
      inputs and on a flat landscape, and a witness printed: after 0-50
      steps, kernel against plain version and plain float32 against
      float64.

Each kernel's entry in the kernels line carries its bound: the larger of
the bytes its function must move over the HBM rate and its operations
over the peak rate of the pipe they need (below).

The last two lines of standard output are a JSON object describing each
kernel, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Phase 2: kernel and plain version sum the same float32 scores over the
# points in different orders (warp butterfly vs PyTorch's reduction), so
# costs agree to a few float32 ulps of the sum (|cost| ~ 1e2 here, ulp ~ 8e-6;
# 384 reordered terms bound the error near 2e-5 relative).  Poses come from
# identical Threefry draws and strict-< decisions, so they agree unless two
# particles' costs tie within that error.
COST_RTOL = 1e-5
COST_ATOL = 1e-4
POSE_ATOL = 1e-5
# Phase 3: the rollout kernel reproduces local_exact's trajectory, as the
# JAX package's own test of the same pair holds it (tests/test_rollout.py).
TRAJ_ATOL = 5e-4
# Phase 4: bench.py's per-robot SLAM gate.
GATE_MEAN_M = 0.35
GATE_MAX_M = 0.7


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# Peak rates of one H100 SXM at its 700 W limit: NVIDIA's data sheet (HBM,
# FP32 outside the tensor cores, dense TF32 and bf16 tensor cores) and, for
# exp/exp2, the special-function units: 16 lanes per SM (Hopper white paper)
# x 132 SMs x the 1.98 GHz clock that the 67 TFLOP/s FP32 figure implies.
HBM_BYTES_S = 3.35e12
# int32: the 64 INT32 lanes of each SM (Hopper white paper) at the same clock.
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "sfu": 132 * 16 * 1.98e9,
        "int32": 132 * 64 * 1.98e9}
# One Threefry-2x32 block: 20 rounds of an add, a rotate (one funnel shift)
# and a xor, five key injections of two adds, the two counter adds.
THREEFRY_INT_OPS = 20 * 3 + 5 * 2 + 2


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


# rollout_local's point evaluation (csrc/rollout_local.cu): the rigid
# transform (8), the cell binning (4), the residual (2), the quadratic form
# (9), -q/2 and the sum (2) on the FP32 pipes, one exp.
ROLLOUT_LOCAL_FLOPS = 25


def _nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms=None, **extra):
    """One kernel's entry of the kernels line."""
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=library_ms, **extra)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    from ndtpso_slam_tpu_torch.ops import (_build, probes, rollout, rollout_bisect, rollout_local,
                                           row_scatter, score, score_variants)

    t0 = time.perf_counter()
    paths = _build.build(rollout_local.LIB, rollout.LIB, score.LIB, score_variants.LIB,
                         row_scatter.LIB, probes.LIB, rollout_bisect.LIB)
    print(f"[phase 1] built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for path in paths:
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[phase 1] {path.stem.split('-')[0]}: {line.strip()}")


def _small_world(dev):
    """A small built map (an ellipse of 300 points, two scans) and its points
    padded to 384 beams."""
    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.models import ndt_map

    mc = C.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 300, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1)
           + rs.normal(0, 0.05, (300, 2))).astype(np.float32)
    st = ndt_map.init_map(mc, device=dev)
    for _ in range(2):
        noisy = pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)
        ndt_map.add_points(st, mc, torch.from_numpy(noisy).to(dev),
                           torch.ones(300, dtype=torch.bool, device=dev))
        ndt_map.build(st, mc)
    points = torch.zeros((384, 2), device=dev)
    points[:300] = torch.from_numpy(pts).to(dev)
    valid = torch.zeros(384, dtype=torch.bool, device=dev)
    valid[:300] = True
    return mc, ndt_map.snapshot(st, mc), points, valid


def _pack(snap, mc, guesses, points, valid):
    import torch

    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    packed = [
        rl.pack_rollout_local_inputs(
            cost.bind_neighborhood(g, snap, points, valid, mc), points
        )
        for g in guesses
    ]
    return torch.stack([s for s, _ in packed]), torch.stack([p for _, p in packed])


def compare_kernel(keys, guesses, devs, sten, pts, cfg, mc):
    """Kernel and plain version on the same inputs; returns max |pose diff|,
    max |cost diff|."""
    import torch

    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    kp, kc = rl.pso_rollout_local(keys, guesses, devs, sten, pts, cfg, mc)
    torch.cuda.synchronize()
    rp, rc = rl.pso_rollout_local_reference(keys, guesses, devs, sten, pts, cfg, mc)
    torch.cuda.synchronize()
    check(torch.isfinite(kp).all() and torch.isfinite(kc).all(), "kernel output not finite")
    dpose = (kp - rp).abs().max().item()
    dcost = (kc - rc).abs().max().item()
    ok_cost = torch.allclose(kc, rc, rtol=COST_RTOL, atol=COST_ATOL)
    check(ok_cost and dpose <= POSE_ATOL,
          f"kernel vs plain: max |dpose| {dpose:.3e}, max |dcost| {dcost:.3e}")
    return dpose, dcost


def phase_kernel():
    import torch

    from ndtpso_slam_tpu_torch import config as C

    dev = torch.device("cuda")
    mc, snap, points, valid = _small_world(dev)
    rs = np.random.RandomState(1)
    worst = 0.0
    for pop in (50, 200):
        b = 3
        cfg = C.PSOConfig(iterations=10, population=pop)
        keys = torch.from_numpy(rs.randint(0, 2**31, (b, 2)).astype(np.int64)).to(dev)
        guesses = torch.from_numpy(rs.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)).to(dev)
        devs = torch.tensor([[0.2, 0.2, 0.05]] * b, device=dev)
        sten, pts = _pack(snap, mc, guesses, points, valid)
        dpose, dcost = compare_kernel(keys, guesses, devs, sten, pts, cfg, mc)
        worst = max(worst, dpose, dcost)
        print(f"[phase 2] B={b} N=384 P={pop} I=10: max |dpose| {dpose:.3e} "
              f"max |dcost| {dcost:.3e}")
    return worst


def phase_paths():
    import dataclasses

    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode

    lg = synthetic.make_log(seed=3, n_scans=8, n_beams=256, world_size=30.0,
                            odom_noise=0.02)
    base = NodeConfig(frame_size_m=36.0, cell_side_m=0.5, window_slots=4,
                      max_beams=256, pso_iterations=25, pso_population=50,
                      init_pose=tuple(lg.poses[0]), cost_mode="local_exact")
    ref = SlamNode(base, verbose=False).run_log(lg)
    got = SlamNode(dataclasses.replace(base, cost_mode="rollout_local"),
                   verbose=False).run_log(lg)
    diff = float(np.abs(got - ref).max())
    check(diff <= TRAJ_ATOL, f"rollout_local vs local_exact trajectory: {diff:.3e}")
    print(f"[phase 3] 8 scans rollout_local vs local_exact: max |dpose| {diff:.3e}")


def phase_main():
    import torch

    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    lg = synthetic.make_log(seed=2, n_scans=50, n_beams=360, world_size=50.0)
    cfg = NodeConfig(frame_size_m=300.0, cell_side_m=0.5, window_slots=100,
                     pso_iterations=30, pso_population=50, max_beams=384,
                     cost_mode="rollout_local", build_og=False,
                     init_pose=tuple(lg.poses[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    node = SlamNode(cfg, verbose=False)
    step_s = []
    rl.pso_rollout_local.LAUNCHES = 0
    t0 = time.perf_counter()
    for i in range(len(lg.ranges)):
        ts = time.perf_counter()
        node.process_scan(lg.ranges[i], lg.angle_min, lg.angle_increment,
                          lg.range_max, timestamp=float(lg.timestamps[i]))
        step_s.append(time.perf_counter() - ts)  # ends in the pose's copy to the host
    total = time.perf_counter() - t0
    launches = rl.pso_rollout_local.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    poses = np.stack(node.poses)
    err = np.hypot(poses[:, 0] - lg.poses[:, 0], poses[:, 1] - lg.poses[:, 1])
    check(np.isfinite(poses).all() and poses.shape == (50, 3), "poses not finite [50, 3]")
    aligns = len(lg.ranges) - 1  # the first scan is not aligned
    check(launches == aligns, f"kernel launches {launches} != aligns {aligns}")
    check(err.mean() < GATE_MEAN_M and err.max() < GATE_MAX_M,
          f"trajectory gate: mean {err.mean():.4f} m, max {err.max():.4f} m")
    aligned = np.array(step_s[1:]) * 1e3
    print(f"[phase 4] 300 m / 0.5 m / 100 slots / P=50 I=30 / N=384, 50 scans: "
          f"mean err {err.mean():.4f} m, max {err.max():.4f} m; "
          f"{len(lg.ranges) / total:.2f} scans/s; aligned-step latency "
          f"p50 {np.percentile(aligned, 50):.3f} ms p95 {np.percentile(aligned, 95):.3f} ms; "
          f"peak device memory {peak / 2**30:.3f} GiB; kernel launches {launches}")
    return node, lg, launches


def _events_ms(fn, reps):
    """ms per call over reps calls after a warm one (CUDA events)."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import time_ms

    return time_ms(fn, reps, torch.device("cuda"))


def phase_main_kernel(node, lg):
    """Kernel vs plain version, compared and timed, on the inputs of the solve
    the main path would run next (B=1, N=384, P=50, I=30): the final map, the
    final pose as guess, the last scan."""
    import torch

    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.ops import rng
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    cfg = node.slam_cfg
    st = node.state
    scan = scan_mod.load_laser(lg.ranges[-1], lg.angle_min, lg.angle_increment,
                               lg.range_max, cfg.scan, cfg.map)
    snap = ndt_map.snapshot(st.map, cfg.map)
    guess = st.pose[None]
    devs = torch.abs(st.align.pose_diff * cfg.deviation_scale)[None]
    sten, pts = _pack(snap, cfg.map, guess, scan.points, scan.valid)
    keys = torch.tensor([rng.derive_key(node._key, st.step)], dtype=torch.int64,
                        device=guess.device)
    args = (keys, guess, devs, sten, pts, cfg.pso, cfg.map)
    dpose, dcost = compare_kernel(*args)
    ms = _events_ms(lambda: rl.pso_rollout_local(*args), 50)
    plain_ms = _events_ms(lambda: rl.pso_rollout_local_reference(*args), 5)
    bnd = _rollout_local_bound(sten, pts, cfg.pso.population, [cfg.pso.iterations])
    print(f"[phase 4] kernel vs plain on the next solve's inputs: max |dpose| "
          f"{dpose:.3e} max |dcost| {dcost:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bnd[0]:.6f} ms ({bnd[1]}; one solve: one SM of 132, latency-bound)")
    return max(dpose, dcost), ms, plain_ms, bnd


def _evaluations(population, live_iterations):
    """Particle evaluations of whole solves: the gbest seed, the population,
    and the population again in each iteration a solve ran."""
    return sum(1 + population * (1 + int(i)) for i in live_iterations)


def _rollout_local_bound(sten, pts, population, live_iterations):
    pairs = _evaluations(population, live_iterations) * pts.shape[-2]  # pts [B, N, 8]
    return bound(_nbytes(sten, pts), fp32=ROLLOUT_LOCAL_FLOPS * pairs, sfu=pairs)


def _rollout_bound(sten, pts, population, live_iterations, score_dtype="f32"):
    """K2's bound: each evaluation scores the N points (15 features); bf16
    operands could contract on the tensor cores."""
    pairs = _evaluations(population, live_iterations) * pts.shape[-1]  # pts [B, 8, N]
    zpipe = "bf16" if score_dtype == "bf16" else "fp32"
    return bound(_nbytes(sten, pts), **score_ops(pairs, 15, zpipe, masked=False))


def _live_iterations(binds, early_exit, iterations):
    """Iterations each solve of a plain frozen solve ran, from the incumbents
    its cost evaluations were bound at (ops/rollout.py:packed_frozen_cost):
    calls 0 and 1 are the seed and the population, call 2 + i is iteration
    i, bound at the incumbent of its start.  The incumbent moves exactly
    when it improves, which resets the stall count
    (models/pso.py:pso_solve_batch)."""
    import torch

    if early_exit <= 0:
        return [iterations] * binds[0].shape[0]
    g = torch.stack(binds[2:]).cpu()  # [iterations run, B, 3]
    live = []
    for s in range(g.shape[1]):
        n, stale = 0, 0
        for i in range(g.shape[0]):
            if stale >= early_exit:
                break
            n += 1
            if i + 1 < g.shape[0]:
                stale = 0 if not torch.equal(g[i + 1, s], g[i, s]) else stale + 1
        live.append(n)
    return live


# Phase 5: the frozen rollout kernel against its plain version.  The kernel
# sums z = w . phi feature by feature and the scores point by point; the
# plain version uses matrix products (cuBLAS, full float32), so costs differ
# in float32 sum order and a PSO decision between nearly equal particles may
# flip: the JAX package's own tolerance between its rollout kernel and the
# same solve in XLA (tests/test_rollout.py).
FROZEN_COST_RTOL = 1e-4
FROZEN_COST_ATOL = 1e-3
FROZEN_POSE_ATOL = 5e-3
# bf16 operands: one bfloat16 rounding of w and phi, where an ulp of the
# inputs can move a rounding (tests/test_rollout.py's bf16 tolerance).
BF16_COST_RTOL = 2e-2
BF16_POSE_ATOL = 5e-2
# The scoring kernel is held to the exact (float64) value of the same sum:
# its error may be at most SCORE_SLACK times the plain float32 version's, or
# SCORE_ATOL.  A fixed tolerance between the two float32 orders does not
# fit this workload: at 30 m ranges and thin cells the 15 terms of
# z = w . phi reach ~1e4 and cancel down to z ~ 1, so the summation order
# alone moves a cost by ~1e-3.
SCORE_SLACK = 2.0
SCORE_ATOL = 1e-4
# bench.py:336, the batch accuracy gate.
GATE_MEDIAN_XY_M = 0.05
GATE_MEDIAN_TH_RAD = 0.01
BATCH = 256
BATCH_SMALL = 16
REPS = 6  # bench.py's --reps


def _compare(name, got, ref, cost_rtol, cost_atol, pose_atol):
    """Held against each other: (pose, cost) pairs; returns (dpose, dcost)."""
    import torch

    (kp, kc), (rp, rc) = got, ref
    check(torch.isfinite(kp).all() and torch.isfinite(kc).all(), f"{name}: kernel output not finite")
    dpose = (kp - rp).abs().max().item()
    dcost = (kc - rc).abs().max().item()
    check(torch.allclose(kc, rc, rtol=cost_rtol, atol=cost_atol) and dpose <= pose_atol,
          f"{name} kernel vs plain: max |dpose| {dpose:.3e}, max |dcost| {dcost:.3e}")
    return dpose, dcost


_ROLLOUT_VARIANTS = {
    "rollout": (dict(), FROZEN_COST_RTOL, FROZEN_COST_ATOL, FROZEN_POSE_ATOL),
    "rollout_bf16": (dict(score_dtype="bf16"), BF16_COST_RTOL, 0.0, BF16_POSE_ATOL),
    "rollout_turbo": (dict(rng_mode="native"), FROZEN_COST_RTOL, FROZEN_COST_ATOL, FROZEN_POSE_ATOL),
}
# Per whole-solve kernel: (cost rtol, cost atol, pose atol), the same at
# every width.
_TOLERANCES = {name: tol for name, (_, *tol) in _ROLLOUT_VARIANTS.items()}
_TOLERANCES["rollout_local_turbo"] = (COST_RTOL, COST_ATOL, POSE_ATOL)


def _compare_wide(name, got, ref, true):
    """A whole-solve kernel against its plain version at full width, over
    every solve, with the tolerances of phase 5a; the plain version must
    also pass the accuracy gate.  Returns (max |dpose|, max |dcost|)."""
    dpose, dcost = _compare(name, got, ref, *_TOLERANCES[name])
    err = np.abs(ref[0].cpu().numpy() - true)
    med_xy, med_th = float(np.median(err[:, :2])), float(np.median(err[:, 2]))
    check(med_xy < GATE_MEDIAN_XY_M and med_th < GATE_MEDIAN_TH_RAD,
          f"{name} plain version: accuracy gate: median xy {med_xy:.4f} m, th {med_th:.5f} rad")
    print(f"[phase 5] {name} kernel vs plain over {len(true)} solves: max |dpose| {dpose:.3e}, "
          f"max |dcost| {dcost:.3e}; plain version median xy {med_xy:.4f} m, th {med_th:.5f} rad")
    return dpose, dcost


def phase_batch_kernels(world):
    """5a: each kernel against its plain version on small inputs.  Returns
    {kernel name: max abs error}."""
    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.ops import score as sc

    dev = world["args"][0].device
    mc, snap, points, valid = _small_world(dev)
    rs = np.random.RandomState(2)
    b = 3
    keys = torch.from_numpy(rs.randint(0, 2**31, (b, 2)).astype(np.int64)).to(dev)
    guesses = torch.from_numpy(rs.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)).to(dev)
    devs = torch.tensor([[0.2, 0.2, 0.05]] * b, device=dev)
    nbr = cost.bind_neighborhood(guesses, snap, points.expand(b, -1, -1),
                                 valid.expand(b, -1), mc)
    sten, pts = ro.pack_rollout_inputs(nbr, points.expand(b, -1, -1))
    worst = {}
    cases = [(name, pop, 0) for name in _ROLLOUT_VARIANTS for pop in (50, 200, 4096)]
    cases.append(("rollout", 200, 2))
    for name, pop, ee in cases:
        pop = min(pop, world["pso_cfg"].population)
        kw, crtol, catol, patol = _ROLLOUT_VARIANTS[name]
        args = (keys, guesses, devs, sten, pts, C.PSOConfig(iterations=10, population=pop), mc)
        got = ro.pso_rollout(*args, early_exit=ee, **kw)
        torch.cuda.synchronize()
        ref = ro.pso_rollout_reference(*args, early_exit=ee, **kw)
        dpose, dcost = _compare(name, got, ref, crtol, catol, patol)
        worst[name] = max(worst.get(name, 0.0), dpose, dcost)
        print(f"[phase 5a] {name} B={b} N=384 P={pop} I=10 ee={ee}: "
              f"max |dpose| {dpose:.3e} max |dcost| {dcost:.3e}")

    lsten, lpts = rl.pack_rollout_local_inputs(nbr, points.expand(b, -1, -1))
    args = (keys, guesses, devs, lsten, lpts, C.PSOConfig(iterations=10, population=50), mc)
    got = rl.pso_rollout_local(*args, rng_mode="native")
    torch.cuda.synchronize()
    ref = rl.pso_rollout_local_reference(*args, rng_mode="native")
    dpose, dcost = _compare("rollout_local_turbo", got, ref, *_TOLERANCES["rollout_local_turbo"])
    worst["rollout_local_turbo"] = max(dpose, dcost)
    print(f"[phase 5a] rollout_local_turbo B={b} N=384 P=50 I=10: "
          f"max |dpose| {dpose:.3e} max |dcost| {dcost:.3e}")

    worst["score"] = _check_score(_score_inputs(world, 4), "5a", "B=4 N=384 P=4096 F=15")
    return worst


def _check_score(ops, phase, shape):
    """The scoring kernel against its plain version and the float64 value of
    the same sum; returns max |kernel - plain|."""
    import torch

    from ndtpso_slam_tpu_torch.ops import score as sc

    got = sc.fused_bound_scores(*ops)
    torch.cuda.synchronize()
    ref = sc.fused_bound_scores_reference(*ops)
    exact = sc.fused_bound_scores_reference(*(t.double() for t in ops))
    check(torch.isfinite(got).all(), "score: kernel output not finite")
    dcost = (got - ref).abs().max().item()
    err_k = (got.double() - exact).abs().max().item()
    err_p = (ref.double() - exact).abs().max().item()
    check(err_k <= max(SCORE_SLACK * err_p, SCORE_ATOL),
          f"score kernel: max error {err_k:.3e} against float64, plain float32 {err_p:.3e}")
    print(f"[phase {phase}] score {shape}: max |kernel - plain| {dcost:.3e}; against float64: "
          f"kernel {err_k:.3e}, plain {err_p:.3e}")
    return dcost


def batch_world(b, dev, iterations=50, population=4096):
    """bench.py's batch workload (bench.py:232-292), built with the port's own
    modules and bench.py's seeds: a 64 m map of 1 m cells with 4 slots, built
    from three jittered reference scans of make_world(seed=1, size=50,
    n_boxes=8); B query scans from true offsets U(+-0.3 m, +-0.3 m,
    +-0.05 rad); P=4096, I=50; 360 beams padded to 384."""
    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.models import scan as scan_mod

    map_cfg = C.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=4)
    pso_cfg = C.PSOConfig(iterations=iterations, population=population)
    scan_cfg = C.ScanConfig(max_beams=384)
    beams, amin, inc, rmax = 360, -np.pi, 2 * np.pi / 360, 30.0
    rs = np.random.RandomState(0)
    segs = synthetic.make_world(seed=1, size=50.0, n_boxes=8)
    true = np.stack([rs.uniform(-0.3, 0.3, b), rs.uniform(-0.3, 0.3, b),
                     rs.uniform(-0.05, 0.05, b)], -1)
    ref = scan_mod.load_laser(
        synthetic.raycast(segs, np.zeros(3), beams, amin, inc, rmax).astype(np.float32),
        amin, inc, rmax, scan_cfg, map_cfg, device=dev)
    state = ndt_map.init_map(map_cfg, device=dev)
    ref_pts = ref.points.cpu().numpy()
    for _ in range(3):
        jit_pts = (ref_pts + rs.normal(0, 0.03, (384, 2))).astype(np.float32)
        ndt_map.add_points(state, map_cfg, torch.from_numpy(jit_pts).to(dev), ref.valid)
        ndt_map.build(state, map_cfg)
    snap = ndt_map.snapshot(state, map_cfg)
    snaps = ndt_map.MapSnapshot(
        *(t[None].expand(b, *t.shape).contiguous() for t in (snap.mean, snap.inv_cov, snap.built)))
    scans = [scan_mod.load_laser(synthetic.raycast(segs, true[i], beams, amin, inc, rmax)
                                 .astype(np.float32), amin, inc, rmax, scan_cfg, map_cfg,
                                 device=dev) for i in range(b)]
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32).astype(np.int64)
    return dict(
        map_cfg=map_cfg, pso_cfg=pso_cfg, true=true,
        args=(torch.from_numpy(keys).to(dev), torch.zeros((b, 3), device=dev),
              torch.tensor([[0.5, 0.5, 0.1]] * b, device=dev), snaps,
              torch.stack([s.points for s in scans]), torch.stack([s.valid for s in scans])),
    )


def _first(world, n):
    """The first n solves of a batch world."""
    from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot

    keys, guesses, devs, snaps, points, valid = world["args"]
    snaps = MapSnapshot(snaps.mean[:n], snaps.inv_cov[:n], snaps.built[:n])
    return dict(world, true=world["true"][:n],
                args=(keys[:n], guesses[:n], devs[:n], snaps, points[:n], valid[:n]))


def _score_inputs(world, n):
    """The scoring kernel's operands for the first n solves of the world:
    the bind at each guess and phi of the population's initial poses."""
    import torch

    from ndtpso_slam_tpu_torch.models import cost, pso

    keys, guesses, devs, snaps, points, valid = _first(world, n)["args"]
    bound = cost.bind_points(guesses, snaps, points, valid, world["map_cfg"])
    _, u_p = pso._batch_draws(keys, None, world["pso_cfg"].population, torch.float32,
                              guesses.device, "threefry")
    poses = guesses[:, None, :] + (2.0 * u_p - 1.0) * devs[:, None, :]
    return cost.pose_features_t(poses, bound.bind_pose), bound.w, bound.mask


def _packed(world, local=False):
    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    keys, guesses, devs, snaps, points, valid = world["args"]
    nbr = cost.bind_neighborhood(guesses, snaps, points, valid, world["map_cfg"])
    pack = rl.pack_rollout_local_inputs if local else ro.pack_rollout_inputs
    return (keys, guesses, devs, *pack(nbr, points), world["pso_cfg"], world["map_cfg"])


def _launch_counts():
    from ndtpso_slam_tpu_torch.ops import probes
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.ops import row_scatter as rsc
    from ndtpso_slam_tpu_torch.ops import score as sc
    from ndtpso_slam_tpu_torch.ops import score_variants as sv

    return dict(rollout=ro.pso_rollout, rollout_local=rl.pso_rollout_local,
                score=sc.fused_bound_scores, score_variants=sv.score_variants,
                score_block=sv.score_block, row_scatter=rsc.row_scatter,
                io_probe=probes.io_probe, mosaic_probe=probes.mosaic_probe,
                rollout_bisect=rb.rollout_bisect)


def _reset_counts():
    for fn in _launch_counts().values():
        fn.LAUNCHES = 0


def _read_counts():
    return {name: fn.LAUNCHES for name, fn in _launch_counts().items()}


# Per cost mode: the kernel library it must launch, and how often per call.
def _expected_launches(mode, iterations):
    if mode.startswith("rollout_local"):
        return {"rollout_local": 1}
    if mode.startswith("rollout"):
        return {"rollout": 1}
    return {"score": iterations + 2}  # the seed, the population, each iteration


def _profile(fn):
    """One call under torch.profiler: (kernel launches, device busy ms, wall ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                  for e in kern)
    return sum(e.count for e in kern), busy_us / 1e3, wall


def _recorded_binds(fn):
    """Runs fn with the plain frozen cost (ops/rollout.py:packed_frozen_cost)
    recording the incumbent of each evaluation; returns (fn's result, the
    incumbents)."""
    from unittest import mock

    from ndtpso_slam_tpu_torch.ops import rollout as ro

    seen, cost = [], ro.packed_frozen_cost

    def recording(poses, binds, *args, **kwargs):
        seen.append(binds.detach().clone())
        return cost(poses, binds, *args, **kwargs)

    with mock.patch.object(ro, "packed_frozen_cost", recording):
        return fn(), seen


def phase_batch(world):
    """5b: solve_batch at full width.  Returns {kernel name: (launches, ms,
    plain ms, max abs err, bound)} for the kernels it times."""
    import torch

    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import score as sc
    from ndtpso_slam_tpu_torch.parallel import mesh

    b = world["true"].shape[0]
    cfg = world["pso_cfg"]
    out = {}
    for mode, ee, kname in (("rollout", 0, "rollout"), ("rollout_turbo", 2, "rollout_turbo"),
                            ("fast_fused", 0, "score")):
        run = lambda: mesh.solve_batch(*world["args"], world["map_cfg"], cfg, mode, early_exit=ee)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = _read_counts()
        want = _expected_launches(mode, cfg.iterations)
        check(all(counts[k] == want.get(k, 0) for k in counts),
              f"{mode}: launches {counts}, expected {want}")
        pose = res.pose.cpu().numpy()
        check(np.isfinite(pose).all() and pose.shape == (b, 3), f"{mode}: poses not finite [{b}, 3]")
        err = np.abs(pose - world["true"])
        med_xy, med_th = float(np.median(err[:, :2])), float(np.median(err[:, 2]))
        check(med_xy < GATE_MEDIAN_XY_M and med_th < GATE_MEDIAN_TH_RAD,
              f"{mode}: accuracy gate: median xy {med_xy:.4f} m, median th {med_th:.5f} rad")
        run()  # bench.py's protocol: one warm call, then enqueue REPS, sync once
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [run() for _ in range(REPS)]
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        del outs
        launches, busy_ms, wall_ms = _profile(run)
        print(f"[phase 5b] solve_batch {mode} ee={ee} B={b} P={cfg.population} "
              f"I={cfg.iterations} N=384: median xy {med_xy:.4f} m, median th {med_th:.5f} rad, "
              f"max xy {err[:, :2].max():.4f} m; first call {first_s:.3f} s; "
              f"{REPS} reps in {total:.3f} s -> {b * REPS / total:.1f} solves/s; "
              f"launches {counts}; profiled call: {launches} device kernels, busy "
              f"{busy_ms:.3f} of {wall_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")

        # The mode's kernel against its plain version on this call's inputs.
        if kname == "score":
            ops = _score_inputs(world, b)
            kern = lambda: sc.fused_bound_scores(*ops)
            plain = lambda: sc.fused_bound_scores_reference(*ops)
            shape = f"B={b} N=384 P={cfg.population}, one cost evaluation"
            derr = _check_score(ops, "5b", shape)
            bnd = _score_bound(ops)
        else:
            packed = _packed(world)
            kw = dict(early_exit=ee, rng_mode="native" if "turbo" in mode else "threefry")
            kern = lambda: ro.pso_rollout(*packed, **kw)
            plain = lambda: ro.pso_rollout_reference(*packed, **kw)
            ref, binds = _recorded_binds(plain)
            derr = max(_compare_wide(mode, kern(), ref, world["true"]))
            live = _live_iterations(binds, ee, cfg.iterations)
            bnd = _rollout_bound(packed[3], packed[4], cfg.population, live)
            shape = (f"B={b} N=384 P={cfg.population} I={cfg.iterations} ee={ee}, one solve_batch; "
                     f"iterations run {sum(live)} of {b * cfg.iterations}")
        ms = _events_ms(kern, 3)
        plain_ms = _events_ms(plain, 1)
        print(f"[phase 5b] {kname} kernel vs plain ({shape}): max abs err {derr:.3e}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        launches_main = counts["score" if kname == "score" else "rollout"]
        out[kname] = (launches_main, ms, plain_ms, derr, bnd)
    return out


def _score_bound(ops):
    """K3's bound: phit, w and mask read, the costs written, every
    (point, particle) pair scored on the FP32 pipes."""
    phit, w, mask = ops
    b, f, p = phit.shape
    return bound(_nbytes(phit, w, mask) + 4.0 * b * p, **score_ops(b * p * w.shape[1], f))


def phase_batch_small(world):
    """5c: the other batch modes at B=16, the same widths: finite results
    and launch counts; rollout_bf16 and rollout_local_turbo against their
    plain versions, timed.  Returns {kernel name: (launches, ms, plain ms,
    max abs err, bound)}."""
    import torch

    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.parallel import mesh

    small = _first(world, BATCH_SMALL)
    cfg = small["pso_cfg"]
    out = {}
    for mode in ("rollout_bf16", "rollout_turbo_bf16", "fast_local_fused", "rollout_local_turbo"):
        _reset_counts()
        res = mesh.solve_batch(*small["args"], small["map_cfg"], cfg, mode)
        torch.cuda.synchronize()
        counts = _read_counts()
        want = _expected_launches(mode, cfg.iterations)
        check(all(counts[k] == want.get(k, 0) for k in counts),
              f"{mode}: launches {counts}, expected {want}")
        check(torch.isfinite(res.pose).all() and torch.isfinite(res.cost).all(),
              f"{mode}: results not finite")
        err = np.abs(res.pose.cpu().numpy() - small["true"])
        print(f"[phase 5c] solve_batch {mode} B={BATCH_SMALL} P={cfg.population} "
              f"I={cfg.iterations} N=384: finite; median xy {np.median(err[:, :2]):.4f} m, "
              f"median th {np.median(err[:, 2]):.5f} rad; launches {counts}")
        if mode == "rollout_bf16":
            packed = _packed(small)
            kern = lambda: ro.pso_rollout(*packed, score_dtype="bf16")
            plain = lambda: ro.pso_rollout_reference(*packed, score_dtype="bf16")
            derr = max(_compare_wide(mode, kern(), plain(), small["true"]))
            name = "rollout_bf16"
            lc = counts["rollout"]
            bnd = _rollout_bound(packed[3], packed[4], cfg.population,
                                 [cfg.iterations] * BATCH_SMALL, "bf16")
        elif mode == "rollout_local_turbo":
            packed = _packed(small, local=True)
            kern = lambda: rl.pso_rollout_local(*packed, rng_mode="native")
            plain = lambda: rl.pso_rollout_local_reference(*packed, rng_mode="native")
            derr = max(_compare_wide(mode, kern(), plain(), small["true"]))
            name = "rollout_local_turbo"
            lc = counts["rollout_local"]
            bnd = _rollout_local_bound(packed[3], packed[4], cfg.population,
                                       [cfg.iterations] * BATCH_SMALL)
        else:
            continue
        ms = _events_ms(kern, 3)
        plain_ms = _events_ms(plain, 1)
        print(f"[phase 5c] {name} kernel vs plain (B={BATCH_SMALL} N=384 P={cfg.population} "
              f"I={cfg.iterations}): max abs err {derr:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        out[name] = (lc, ms, plain_ms, derr, bnd)
    return out


# Phase 6: a scoring variant against its plain version.  Both make the same
# roundings, so they differ by the order of the sums (rtol 1e-5, atol 1e-4:
# the scoring kernel's own tolerance) and, where a score is rounded (the
# tensor-core reductions, the score block's bf16all), by the few terms whose
# z the two sum orders put on either side of a rounding boundary.  Such a
# flip moves one term by one ulp of a score <= 1 times a mask of 0 or 1:
# 2^-11 for TF32, 2^-8 for bf16, up to 2^-7 for bf16all (its max(z, 0),
# exponent and score are each rounded).  At these shapes the card shows at
# most one flip per cost (3.906e-03 in E1 bf16 and E3 bf16all, PERF.md);
# each limit allows FLIPS.
FLIPS = 4
VARIANT_TOL = {"cores": (1e-5, 1e-4), "tf32": (1e-5, 1e-4 + FLIPS * 2.0**-11),
               "bf16": (1e-5, 1e-4 + FLIPS * 2.0**-8)}
BLOCK_TOL = {"bf16all": (1e-5, 1e-4 + FLIPS * 2.0**-7)}
SRC = "ndtpso_slam_tpu_torch/csrc/"


def _variant_tol(zroute, reduce):
    if reduce == "cores":
        return VARIANT_TOL["cores"]
    return VARIANT_TOL["bf16" if zroute == "bf16" else "tf32"]


def _variant_ops(pairs, features, zroute, reduce, masked=True):
    zpipe = {"bf16": "bf16", "tf32": "tf32"}.get(zroute, "fp32")
    rpipe = ("bf16" if zroute == "bf16" else "tf32") if reduce == "mma" else "fp32"
    return score_ops(pairs, features, zpipe, rpipe, masked)


def _study_entry(name, source, replaces, launches, variants, ref, library_ms=None):
    """A study's entry: the numbers of its reference variant, the largest
    error of any variant, and every variant under "variants"."""
    v = variants[ref]
    return _entry(name, SRC + source, replaces, launches,
                  max(x["max_abs_err"] for x in variants.values()), v["ms"], v["plain_ms"],
                  (v["bound_ms"], v["bound_by"]), library_ms, reference_variant=ref,
                  variants=variants)


def _drive(study, run, kernel, want):
    """Runs a study with every launch count set to 0 just before and read
    just after; its kernel must have launched `want` times and no other.
    Returns (the study's result, its launches)."""
    import torch

    torch.cuda.synchronize()
    _reset_counts()
    res = run()
    torch.cuda.synchronize()
    counts = _read_counts()
    expect = {k: (want if k == kernel else 0) for k in counts}
    check(counts == expect, f"{study}: launches {counts}, expected {expect}")
    return res, counts[kernel]


def phase_kernel_variants(dev):
    """6a: experiments/kernel_variants.py's six configurations."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import kernel_variants as kv
    from ndtpso_slam_tpu_torch.ops import score_variants as sv
    from ndtpso_slam_tpu_torch.ops.score import fused_bound_scores

    res, launches = _drive("kernel_variants", lambda: kv.run(dev), "score_variants",
                           len(kv.CONFIGS) * (1 + kv.I))
    phit, w, mask = kv.inputs(dev)
    b, f, p = phit.shape
    nbytes = _nbytes(phit, w, mask) + 4.0 * b * p
    variants = {}
    for name, zroute, reduce, tile in kv.CONFIGS:
        out, diff, ms = res[name]
        got = out[:, 0, :]
        ref = sv.score_variants_reference(phit, w, mask, zroute, reduce)
        rtol, atol = _variant_tol(zroute, reduce)
        err = (got - ref).abs().max().item()
        check(torch.isfinite(got).all() and torch.allclose(got, ref, rtol=rtol, atol=atol),
              f"kernel_variants {name}: max |kernel - plain| {err:.3e}")
        plain_ms = _events_ms(lambda: sv.score_variants_reference(phit, w, mask, zroute, reduce), 3)
        bms, by = bound(nbytes, **_variant_ops(b * p * w.shape[1], f, zroute, reduce))
        variants[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bms, bound_by=by,
                              diff_vs_v0=diff)
        print(f"[phase 6a] {name} (B={b} N={w.shape[1]} P={p}): max |kernel - plain| {err:.3e}, "
              f"vs v0 {diff:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it)")
    # K3 (ops/score.py), the f32 scoring kernel the port ships, on the same
    # inputs: the rate the f32 and tensor-core routes are weighed against.
    k3 = lambda: fused_bound_scores(phit, w, mask)
    got = k3()
    ref = sv.score_variants_reference(phit, w, mask, "f32", "cores")
    err = (got - ref).abs().max().item()
    check(torch.allclose(got, ref, *VARIANT_TOL["cores"]), f"K3 on E1's inputs: max |K3 - plain| {err:.3e}")
    k3_ms = _events_ms(k3, kv.I)
    ms_of = {name: variants[name]["ms"] for name in variants}
    print(f"[phase 6a] K3 score on the same inputs: {k3_ms:.4f} ms (max |K3 - plain| {err:.3e}); "
          + ", ".join(f"{name.split()[0]} {k3_ms / ms:.2f}x K3's rate" for name, ms in ms_of.items()))
    entry = _study_entry("kernel_variants", "score_variants.cu", "experiments/kernel_variants.py:25",
                         launches, variants, kv.CONFIGS[0][0])
    entry["k3_same_inputs_ms"] = k3_ms
    return entry


def phase_rollout_score_variants(dev):
    """6b: experiments/rollout_score_variants.py's five score-block variants."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import rollout_score_variants as rsv
    from ndtpso_slam_tpu_torch.ops import score_variants as sv

    res, launches = _drive("rollout_score_variants", lambda: rsv.run(dev), "score_block",
                           len(rsv.VARIANTS) * (1 + rsv.REPS + 1 + rsv.REPS))
    phit, w = rsv.inputs(dev)
    b, f, p = phit.shape
    variants = {}
    for name in rsv.VARIANTS:
        carry, c, ms, ms_half = res[name]
        rcarry, rc = sv.score_block_reference(phit, w, rsv.I, name)
        rtol, atol = BLOCK_TOL.get(name, VARIANT_TOL["cores"])
        err = (c - rc).abs().max().item()
        check(torch.isfinite(c).all() and torch.allclose(c, rc, rtol=rtol, atol=atol)
              and torch.equal(carry, rcarry) and bool((carry == 0).all()),
              f"rollout_score_variants {name}: max |c - plain| {err:.3e}, carry {carry[:4].tolist()}")
        check(ms > 1.5 * ms_half, f"rollout_score_variants {name}: {ms:.3f} ms at I={rsv.I}, "
              f"{ms_half:.3f} ms at I/2: the iterations do not serialise")
        plain_ms = _events_ms(lambda: sv.score_block_reference(phit, w, rsv.I, name), 1)
        zroute = "bf16" if name.startswith("bf16") else "f32"
        ops = _variant_ops(b * p * w.shape[1] * rsv.I, f, zroute, "cores", masked=False)
        bms, by = bound(_nbytes(phit, w) + 4.0 * b * (p + 1), **ops)
        variants[name] = dict(ms=ms, ms_half_iterations=ms_half, plain_ms=plain_ms,
                              max_abs_err=err, bound_ms=bms, bound_by=by)
        print(f"[phase 6b] {name} (B={b} N={w.shape[1]} P={p} I={rsv.I}): max |c - plain| "
              f"{err:.3e}, carry 0; kernel {ms:.4f} ms ({ms_half:.4f} ms at I={rsv.I // 2}), "
              f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it)")
    return _study_entry("rollout_score_variants", "score_variants.cu",
                        "experiments/rollout_score_variants.py:22", launches, variants, "base")


def _exact_variant_scores(phit, w, mask, zroute):
    """float64 scores of a variant's (rounded) operands, phit [B, 16, P]."""
    from ndtpso_slam_tpu_torch.ops import score_variants as sv

    if zroute == "bf16":
        phit, w = sv.bf16_round(phit), sv.bf16_round(w)
    elif zroute == "tf32":
        phit, w = sv.tf32_round(phit), sv.tf32_round(w)
    z = w.double() @ phit.double()
    return -(mask.double()[:, None, :] @ (-0.5 * z.clamp(min=0.0)).exp())[:, 0, :]


def phase_pallas_variants(dev):
    """6c: experiments/pallas_variants.py's nine variants in the PSO loop."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import pallas_variants as pv
    from ndtpso_slam_tpu_torch.models import cost, pso
    from ndtpso_slam_tpu_torch.ops import score_variants as sv

    calls = (1 + 1 + pv.REPS) * (pv.ITERS + 2)  # warm, timed pair; seed, population, iterations
    res, launches = _drive("pallas_variants", lambda: pv.run(dev), "score_variants",
                           len(pv.VARIANTS) * len(pv.TILES) * calls)
    base = res[pv.BASELINE]
    check(base["med_xy"] < GATE_MEDIAN_XY_M and base["med_th"] < GATE_MEDIAN_TH_RAD,
          f"pallas_variants baseline: median |xy| {base['med_xy']:.4f} m, |th| {base['med_th']:.5f}")
    print(f"[phase 6c] {pv.BASELINE} (B={pv.B} P={pv.P} I={pv.ITERS}): {base['ms']:.1f} ms/batch, "
          f"{base['solves_s']:.1f} solves/s, median |xy| {base['med_xy']:.4f} m, "
          f"|th| {base['med_th']:.5f} rad")

    # The population call's own inputs: binds at the guesses, its poses.
    wd = pv.world(dev)
    _, u_p = pso._batch_draws(wd["keys"], None, pv.P, torch.float32, dev, "threefry")
    poses = wd["guesses"][:, None, :] + (2.0 * u_p - 1.0) * wd["devs"][:, None, :]
    bound_scan = cost.bind_points(wd["guesses"], wd["snaps"], wd["points"], wd["valid"],
                                  wd["map_cfg"])
    phit = sv.pad16(cost.pose_features_t(poses, bound_scan.bind_pose), 1).contiguous()
    w, mask = sv.pad16(bound_scan.w, 2).contiguous(), bound_scan.mask
    b, f, p = phit.shape
    nbytes = _nbytes(phit, w, mask) + 4.0 * b * p
    variants = {}
    for name, (zroute, reduce) in pv.VARIANTS.items():
        exact = _exact_variant_scores(phit, w, mask, zroute)
        for tile in pv.TILES:
            key = f"{name}_t{tile}"
            kern = lambda: sv.score_variants(phit, w, mask, zroute, reduce, tile)
            plain = lambda: sv.score_variants_reference(phit, w, mask, zroute, reduce)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            err_k = (got.double() - exact).abs().max().item()
            err_p = (ref.double() - exact).abs().max().item()
            check(torch.isfinite(got).all() and err_k <= max(SCORE_SLACK * err_p, SCORE_ATOL),
                  f"pallas_variants {key}: max error {err_k:.3e} against float64, "
                  f"plain {err_p:.3e}")
            ms = _events_ms(kern, 20)
            plain_ms = _events_ms(plain, 3)
            bms, by = bound(nbytes, **_variant_ops(b * p * w.shape[1], 15, zroute, reduce))
            r = res[key]
            finding = ""
            if not torch.allclose(r["cost"], base["cost"], rtol=FROZEN_COST_RTOL,
                                  atol=FROZEN_COST_ATOL):
                finding += " FINDING: costs outside the frozen-solve tolerance of the baseline"
            if r["med_xy"] >= GATE_MEDIAN_XY_M or r["med_th"] >= GATE_MEDIAN_TH_RAD:
                finding += " FINDING: misses bench.py's accuracy gate"
            variants[key] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, err_vs_f64=err_k,
                                 plain_err_vs_f64=err_p, bound_ms=bms, bound_by=by,
                                 ms_per_batch=r["ms"], solves_s=r["solves_s"],
                                 cost_maxdiff_vs_baseline=r["maxdiff"], median_xy_m=r["med_xy"],
                                 median_th_rad=r["med_th"])
            print(f"[phase 6c] {key}: {r['ms']:.1f} ms/batch, {r['solves_s']:.1f} solves/s, cost "
                  f"maxdiff vs baseline {r['maxdiff']:.3e}, median |xy| {r['med_xy']:.4f} m, "
                  f"|th| {r['med_th']:.5f} rad{finding}; kernel (B={b} N={w.shape[1]} P={p}) "
                  f"max |kernel - plain| {err:.3e}, vs float64 {err_k:.3e} (plain {err_p:.3e}); "
                  f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, "
                  f"{100 * bms / ms:.1f}% of it)")
    entry = _study_entry("pallas_variants", "score_variants.cu", "experiments/pallas_variants.py:37",
                         launches, variants, "dot_dot_t256")
    entry["baseline"] = {k: base[k] for k in ("ms", "solves_s", "med_xy", "med_th")}
    return entry


def phase_scatter(dev):
    """6d: experiments/scatter_unique_ab.py at W=2 and W=128."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import scatter_unique_ab as su
    from ndtpso_slam_tpu_torch.ops import row_scatter as rsc

    per_width = (1 + su.REPS) + 2 * su.SCAN_T + 2  # timed calls, the scan chain, two checks
    res, launches = _drive("scatter_unique_ab", lambda: su.run(dev), "row_scatter",
                           2 * per_width + (1 + su.REPS))  # and three fields at W=2
    for tag in ("", "_w128"):
        check(res["correct" + tag] and res["duplicate_rule" + tag],
              f"scatter_unique_ab{tag}: unique ids equal index_copy_ {res['correct' + tag]}, "
              f"duplicate rule {res['duplicate_rule' + tag]}")

    ids, rs = su.fleet_ids()
    fid = torch.from_numpy(ids).to(dev)
    vals = torch.from_numpy(rs.randn(su.M, su.W).astype(np.float32)).to(dev)
    vals128 = torch.from_numpy(rs.randn(su.M, su.W_TPU).astype(np.float32)).to(dev)
    variants = {}
    for key, n_rows, idx, v, n_fields in (("w2", su.R, fid, vals, 1), ("w2_3fields", su.R, fid, vals, 3),
                                          ("w128", su.C, fid % su.C, vals128, 1)):
        base = torch.randn((n_rows + 1, v.shape[1]), device=dev)
        vs = [v + k for k in range(n_fields)]
        got = rsc.row_scatter([base.clone() for _ in vs], idx, vs)
        want = rsc.row_scatter_reference([base.clone() for _ in vs], idx, vs)
        check(all(torch.equal(g, r) for g, r in zip(got, want)),
              f"scatter_unique_ab {key}: kernel differs from its plain version")
        del got, want
        ops = [base.clone() for _ in vs]
        plain_ms = _events_ms(lambda: rsc.row_scatter_reference(ops, idx, vs), 3)
        tag = "_w128" if key == "w128" else ""
        ms = res[("row_scatter_3" if n_fields == 3 else "row_scatter") + tag]
        lib_ms = res["index_copy" + tag] if n_fields == 1 else None
        unique = int(torch.unique(idx).numel())
        width = v.shape[1]
        # The M ids, then each target's winning row read once and written
        # once per field: a scatter-set moves no other row.
        bms, by = bound(8.0 * su.M + 2 * n_fields * 4.0 * width * unique)
        variants[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=0.0,
                             bound_ms=bms, bound_by=by, rows=n_rows + 1, width=width,
                             fields=n_fields, unique_rows=unique)
        print(f"[phase 6d] row_scatter {key} ({n_rows + 1} rows x {width}, M={su.M}, {unique} "
              f"distinct targets): kernel = plain bit for bit; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, index_copy_ {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, "
              f"bound {bms:.5f} ms ({by}, {100 * bms / ms:.2f}% of it)")
        del base, ops
    print("[phase 6d] library calls (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in res.items() if isinstance(v, float)))
    entry = _study_entry("scatter_unique_ab", "row_scatter.cu",
                         "experiments/scatter_unique_ab.py:63", launches, variants, "w2",
                         library_ms=variants["w2"]["library_ms"])
    entry["library_calls_ms"] = {k: v for k, v in res.items() if isinstance(v, float)}
    return entry


# Phases 6e-6g, the bring-up probes.  A probe's sums run in another order
# than its plain version's: rtol 1e-5 and atol 1e-5 times the sum of the
# terms' magnitudes (ops/probes.py:io_magnitudes, mosaic_magnitudes).
SUM_RTOL = 1e-5
SUM_ATOL = 1e-5
IO_WIDE = (256, 384)  # C1's batch: B solves of N points
MOSAIC_EXACT = ("col3", "bool11", "threefry")
# slice11's cos: the kernel's cosf and PyTorch's CUDA cos gave the same bits
# on both tiles (PERF.md); two float32 ulps.
COS_RTOL, COS_ATOL = 2.0**-22, 0.0
# A probe's device time: torch.profiler's device busy time over PROFILE_CALLS
# calls, beside the CUDA-event time per call (which, for a launch-bound probe,
# is the wrapper's host time).
PROFILE_CALLS = 10
# The stencil table at C1's batch is 1.6x the 50 MB L2, and calls back to
# back find part of it there: at that shape a probe (and torch.sum) is timed
# one call at a time, each after a read of FLUSH_BYTES that evicts the L2 (a
# read, so the call has no dirty lines of the flush to write back).
FLUSH_BYTES = 400 * 2**20
MOSAIC_SEEDS = (None, 5)  # the script's ones, and seeded random tiles
# E7: the staged rollout kernel at K2's batch shape, on inputs whose points
# bind (experiments/rollout_bisect.py:binding_inputs).
E7_WIDE = dict(b=256, p=4096, n=384, iters=50)
E7_SPLIT = (1, 2, 3)
E7_REPS = 3
# Whole solves at that width, kernel against plain version: the scores'
# sum order can flip a decision between two nearly equal particles.  On an
# H100 the stage-3 solves differed by at most 1.317e-04 in pose and
# 1.831e-04 in cost (PERF.md); the limits allow ~7x that.
E7_WIDE_TOL = (1e-5, 1e-3, 1e-3)
# A check that no decision can move: stage 3 with no PSO step, at that
# width.  Its gcost is the least of the first 1 + P evaluations, so it
# differs from the plain version's by no more than one evaluation's sum
# order moves it, on any landscape (the scores lie in [0, 1], so the sum of
# their magnitudes is |cost|).
# The witness: stage 3 after each of these PSO steps, kernel against the
# plain version in float32 and in float64, on binding_inputs and on a flat
# landscape (_flat_inputs).
E7_TRACE_ITERS = (0, 1, 2, 5, 10, 20, 50)
# Solves whose pose moved more than this count as diverged in the witness.
E7_MOVED = 1e-6
# Per particle evaluation of the staged kernel outside the score: the PSO
# update (10 FP32 operations on each of 3 dims) and -|pos|^2 (6).
E7_UPDATE_FLOPS = 36


def _cold_ms(fn, reps):
    """ms per call of fn with a cold L2: CUDA events around each call, each
    after a FLUSH_BYTES read (which also hides the host's enqueue time)."""
    import torch

    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _device_ms(fn):
    return _profile(lambda: [fn() for _ in range(PROFILE_CALLS)])[1] / PROFILE_CALLS


def _sum_ok(got, want, magnitudes):
    return bool(((got - want).abs() <= SUM_RTOL * want.abs() + SUM_ATOL * magnitudes).all())


def phase_io_probe(dev):
    """6e: experiments/io_probe.py's four probes at the script's shape and at
    C1's batch shape, where the stencil probes stream the [B, 25, 8, N]
    table that K1 and K2 read."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import io_probe as iop
    from ndtpso_slam_tpu_torch.ops import probes

    b_w, n_w = IO_WIDE
    shapes = ((iop.B, iop.N, iop.REPS), (b_w, n_w, 2 * iop.REPS))
    res, launches = _drive("io_probe", lambda: [iop.run(dev, b=b, n=n, reps=r) for b, n, r in shapes],
                           "io_probe", sum(len(iop.PROBES) * (2 + r) for *_, r in shapes))
    sites = {"min": 32, "smem": 96, "sten3": 74, "sten4": 53}
    variants = {}
    for (b, n, reps), by_probe in zip(shapes, res):
        inp = iop.inputs(dev, b, n)
        for name, (got, ms) in by_probe.items():
            args = iop.probe_args(name, inp)
            src = args[0]
            want = probes.io_probe_reference(name, *args)
            err = (got - want).abs().max().item()
            check(torch.isfinite(got).all() and _sum_ok(got, want, probes.io_magnitudes(name, src)),
                  f"io_probe {name} B={b} N={n}: max |kernel - plain| {err:.3e}")
            plain_ms = _events_ms(lambda: probes.io_probe_reference(name, *args), 3)
            dev_ms = _device_ms(lambda: probes.io_probe(name, *args))
            table = src.view(b, -1, 8, n)  # the points as one stencil offset
            library = lambda: torch.sum(table, dim=(1, 3))
            lib_ms = _events_ms(library, reps)
            if (b, n) == IO_WIDE:  # ms and the library's: one cold call at a time
                events_ms = ms
                ms = _cold_ms(lambda: probes.io_probe(name, *args), reps)
                lib_ms = _cold_ms(library, reps)
            nbytes = _nbytes(*args, got)
            bms, by = bound(nbytes, fp32=float(src.numel()))
            key = f"{name}_b{b}_n{n}"
            variants[key] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 max_abs_err=err, bound_ms=bms, bound_by=by, bytes=nbytes,
                                 replaces=f"experiments/io_probe.py:{sites[name]}")
            how = "back to back"
            if (b, n) == IO_WIDE:
                variants[key]["back_to_back_ms"] = events_ms
                how = f"cold L2, one call at a time; back to back {events_ms:.4f} ms"
            print(f"[phase 6e] {name} (B={b} N={n}, {nbytes / 1e6:.3f} MB): max |kernel - plain| "
                  f"{err:.3e}; kernel {ms:.4f} ms ({how}; {nbytes / ms / 1e6:.1f} GB/s; device "
                  f"busy {dev_ms:.4f} ms per call back to back), plain {plain_ms:.4f} ms, "
                  f"torch.sum {lib_ms:.4f} ms, bound {bms:.5f} ms ({by}, {100 * bms / ms:.1f}% of it)")
    ref = f"sten4_b{b_w}_n{n_w}"
    return _study_entry("io_probe", "probes.cu", "experiments/io_probe.py:53", launches, variants,
                        ref, library_ms=variants[ref]["library_ms"])


def _mosaic_ops(name, numel, n_dot):
    if name == "threefry":
        return dict(int32=float(THREEFRY_INT_OPS * numel))
    if name == "dotgen":  # z over 8 rows for n_dot x P pairs, then the sum over n
        return dict(fp32=float(2 * numel * n_dot + n_dot * (numel // 8)))
    return dict(fp32=float(numel))


def _mosaic_library(name, x, n_dot):
    """The one PyTorch call that computes a mosaic probe, as a function of no
    arguments, or None where no single call does (the row constant of col3
    is built once, outside the call)."""
    import torch

    from ndtpso_slam_tpu_torch.ops import probes

    if name == "col3":
        c = torch.tensor([1.0, 2.0] + [3.0] * (probes.ROWS - 2), device=x.device)[:, None]
        return lambda: x + c
    if name == "dotgen":
        head = x[:, :n_dot]
        return lambda: torch.einsum("rn,rq->q", head, x).expand_as(x)
    if name == "bcast_out":
        return lambda: torch.sum(x, dim=1, keepdim=True).expand_as(x)
    return None


def phase_mosaic_probe(dev):
    """6f: experiments/mosaic_probe.py's seven single-op probes on the
    script's [8, 512] tile of ones and on a seeded random tile."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import mosaic_probe as mp
    from ndtpso_slam_tpu_torch.ops import probes

    res, launches = _drive("mosaic_probe", lambda: [mp.run(dev, seed=s) for s in MOSAIC_SEEDS],
                           "mosaic_probe", len(MOSAIC_SEEDS) * len(mp.PROBES) * (2 + mp.REPS))
    variants = {}
    for seed, by_probe in zip(MOSAIC_SEEDS, res):
        x, xi = mp.inputs(dev, seed=seed)
        for name, (got, ms) in by_probe.items():
            arg = xi if name == "threefry" else x
            want = probes.mosaic_probe_reference(name, arg, mp.N)
            err = (got - want).abs().max().item()
            if name in MOSAIC_EXACT:
                ok = torch.equal(got, want)
            elif name == "slice11":
                ok = torch.allclose(got, want, rtol=COS_RTOL, atol=COS_ATOL)
            else:
                ok = _sum_ok(got, want, probes.mosaic_magnitudes(name, x, mp.N))
            check(ok, f"mosaic_probe {name} (seed {seed}): max |kernel - plain| {err:.3e}")
            plain_ms = _events_ms(lambda: probes.mosaic_probe_reference(name, arg, mp.N), 3)
            dev_ms = _device_ms(lambda: probes.mosaic_probe(name, arg, mp.N))
            library = _mosaic_library(name, x, mp.N)
            lib_ms = lib_dev_ms = None
            if library is not None:  # timed as the kernel: back to back, and device busy
                check(_sum_ok(library(), want, probes.mosaic_magnitudes(name, x, mp.N)),
                      f"mosaic_probe {name}: the library call computes another function")
                lib_ms = _events_ms(library, mp.REPS)
                lib_dev_ms = _device_ms(library)
            nbytes = 2.0 * 4 * x.numel()  # the u32 or f32 tile read, the f32 tile written
            bms, by = bound(nbytes, **_mosaic_ops(name, x.numel(), mp.N))
            key = f"{name}_{'ones' if seed is None else f'seed{seed}'}"
            variants[key] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 library_device_ms=lib_dev_ms, max_abs_err=err, bound_ms=bms,
                                 bound_by=by)
            lib = ("" if library is None else f", library {lib_ms:.4f} ms (device busy "
                   f"{lib_dev_ms:.4f} ms per call)")
            print(f"[phase 6f] {key} ([8, {x.shape[1]}]): max |kernel - plain| {err:.3e}"
                  f"{' (bit-equal)' if name in MOSAIC_EXACT else ''}; kernel {ms:.4f} ms (device "
                  f"busy {dev_ms:.4f} ms per call), plain {plain_ms:.4f} ms{lib}, bound "
                  f"{bms:.6f} ms ({by}, {100 * bms / ms:.2f}% of it)")
    return _study_entry("mosaic_probe", "probes.cu", "experiments/mosaic_probe.py:17", launches,
                        variants, "threefry_seed5")


def _bisect_bound(stage, args, p, iters):
    """E7's bound: its inputs read and its output written once; the Threefry
    blocks (the seed's 8 rows, 3 per particle for the population and each
    iteration) on the INT32 lanes, the update and the trivial cost on the
    FP32 pipes, and from stage 3 on the score of every evaluation counted as
    _rollout_bound counts K2's."""
    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb

    pts, sten = args[3], args[4]
    b, n = pts.shape[0], pts.shape[-1]
    ops = {"int32": float(THREEFRY_INT_OPS * b * (8 + 3 * p * (1 + iters))),
           "fp32": float(E7_UPDATE_FLOPS * b * p * (1 + iters))}
    if rb.cost_kind(stage) == "quad":
        for k, v in score_ops(_evaluations(p, [iters] * b) * n, 15, masked=False).items():
            ops[k] = ops.get(k, 0.0) + v
    return bound(_nbytes(*args) + 4.0 * b * 8 * rb.LANES, **ops)


def _bisect_check(tag, stage, got, want, tol=(COST_RTOL, COST_ATOL, POSE_ATOL)):
    """Kernel against plain version: bit for bit where the stage's cost is
    trivial (the draws, the update, -|pos|^2 round alike), the seed's row
    sums (stage 20) in another order, and stages 2-9 within tol = (cost
    rtol, cost atol, pose atol): by default phase 2's, the scores summed in
    another order.  Returns (dpose, dcost)."""
    import torch

    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb

    check(torch.isfinite(got).all(), f"rollout_bisect {tag} stage {stage}: not finite")
    dpose = (got[:, :3] - want[:, :3]).abs().max().item()
    dcost = (got[:, 3:] - want[:, 3:]).abs().max().item()
    if stage == 20:
        ok = torch.allclose(got, want, rtol=SUM_RTOL, atol=0.0)
    elif rb.cost_kind(stage) == "trivial":
        ok = torch.equal(got, want)
    else:
        ok = torch.allclose(got[:, 3:], want[:, 3:], rtol=tol[0], atol=tol[1]) and dpose <= tol[2]
    check(ok, f"rollout_bisect {tag} stage {stage}: max |dpose| {dpose:.3e}, |dcost| {dcost:.3e}")
    return dpose, dcost


def _flat_inputs(args, seed=1):
    """binding_inputs with a flat landscape: every stencil cell's mean within
    0.25 m of its centre and (la, lb, lc) those of a 1 m cell (la, lc in
    [0.5, 1.5], |lb| < 0.3), so many particles score nearly alike."""
    import numpy as np
    import torch

    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb

    keys, guesses, devs, pts, sten = args
    b, n = pts.shape[0], pts.shape[-1]
    rs = np.random.RandomState(seed)
    side = 2 * rb.R + 1

    def u(lo, hi, *shape):
        return torch.from_numpy(rs.uniform(lo, hi, (b, *shape, n)).astype(np.float32)).to(sten.device)

    sten = sten.clone()
    for k in range(rb.K2):
        off = torch.tensor([k % side - rb.R, k // side - rb.R], dtype=torch.float32,
                           device=sten.device)[None, :, None]
        sten[:, k, 0:2] = pts[:, 2:4] + off - rb.MAP.half_size_m + 0.5 + u(-0.25, 0.25, 2)
        sten[:, k, 2], sten[:, k, 3], sten[:, k, 4] = u(0.5, 1.5), u(-0.3, 0.3), u(0.5, 1.5)
    return keys, guesses, devs, pts, sten


def _bisect_first_evaluations(tag, args, p):
    """Stage 3 with no PSO step, kernel against plain version: the gcosts,
    and the plain cost at the kernel's pose against the kernel's gcost, each
    within one evaluation's sum order (E7_TRACE_ITERS' note).  Returns the
    largest |dcost|."""
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb

    keys, guesses, devs, pts, sten = args
    got = rb.rollout_bisect(3, *args, population=p, iterations=0)[:, :4, 0]
    want = rb.rollout_bisect_reference(3, *args, population=p, iterations=0)[:, :4, 0]
    at_pose = ro.packed_frozen_cost(got[:, None, :3], guesses, sten, pts, rb.MAP, rb.R)[:, 0]
    limit = (SUM_RTOL + SUM_ATOL) * want[:, 3].abs()
    dcost = (got[:, 3] - want[:, 3]).abs()
    dpose_cost = (at_pose - got[:, 3]).abs()
    check(bool((dcost <= limit).all() and (dpose_cost <= limit).all()),
          f"rollout_bisect {tag} stage 3, no PSO step: |dcost| {dcost.max().item():.3e}, plain "
          f"cost at the kernel's pose off by {dpose_cost.max().item():.3e} (limit "
          f"{limit.min().item():.3e})")
    dpose = (got[:, :3] - want[:, :3]).abs().max().item()
    print(f"[phase 6g] {tag} inputs, stage 3 with no PSO step (B={pts.shape[0]} P={p} "
          f"N={pts.shape[-1]}): |dcost| {dcost.max().item():.3e}, plain cost at the kernel's pose "
          f"{dpose_cost.max().item():.3e} from its gcost (limit >= {limit.min().item():.3e}); "
          f"|dpose| {dpose:.3e}")
    return dcost.max().item()


def _bisect_witness(tag, args, p):
    """Stage 3 after E7_TRACE_ITERS PSO steps: how far the kernel is from
    the plain version, and the plain float32 version from float64 (the same
    draws), per solve.  Printed, not checked."""
    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb

    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    for iters in E7_TRACE_ITERS:
        outs = [f(3, *a, population=p, iterations=iters)[:, :4, 0].double() for f, a in (
            (rb.rollout_bisect, args), (rb.rollout_bisect_reference, args),
            (rb.rollout_bisect_reference, a64))]
        parts = []
        for name, x, y in (("kernel - plain", outs[0], outs[1]),
                           ("plain - float64", outs[1], outs[2])):
            dpose = (x[:, :3] - y[:, :3]).abs().amax(dim=1)
            moved = int((dpose > E7_MOVED).sum())
            dcost = (x[:, 3] - y[:, 3]).abs().max().item()
            parts.append(f"{name}: max |dpose| {dpose.max().item():.3e} ({moved} solves > "
                         f"{E7_MOVED:g}), |dcost| {dcost:.3e}")
        print(f"[phase 6g] witness, {tag} inputs, {iters} PSO steps: " + "; ".join(parts))


def phase_rollout_bisect(dev, k2_ms):
    """6g: experiments/rollout_bisect.py, every stage at the script's shape
    on its inputs and on inputs whose points bind, then stages 1, 2 and 3 at
    K2's batch shape: the draws and the update, + the bind, + the score,
    beside K2's time from phase 5b."""
    from ndtpso_slam_tpu_torch.experiments import rollout_bisect as rbx
    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb

    wide = dict(E7_WIDE)
    b_w, p_w, n_w, i_w = wide.pop("b"), wide["p"], wide["n"], wide["iters"]

    def drive():
        return (rbx.run(dev), rbx.run(dev, binding=True),
                rbx.run(dev, E7_SPLIT, b=b_w, binding=True, reps=E7_REPS, **wide))

    res, launches = _drive("rollout_bisect", drive, "rollout_bisect",
                           2 * len(rb.STAGES) + len(E7_SPLIT) * (2 + E7_REPS))
    variants = {}
    for tag, make, outs in (("script", rbx.inputs, res[0]), ("binding", rbx.binding_inputs, res[1])):
        args = make(dev)
        errs = {s: _bisect_check(tag, s, got, rb.rollout_bisect_reference(s, *args))
                for s, (got, _) in outs.items()}
        for s, (dpose, dcost) in errs.items():
            variants[f"stage{s}_{tag}"] = dict(max_abs_err=max(dpose, dcost))
        gcost3 = outs[3][0][:, 3, 0].tolist()
        print(f"[phase 6g] {tag} inputs (B={rbx.B} P={rbx.P} N={rbx.N} I={rbx.ITERS}): all "
              f"{len(errs)} stages = plain; max |dpose| {max(e[0] for e in errs.values()):.3e}, "
              f"|dcost| {max(e[1] for e in errs.values()):.3e}; stage 3 gcost {gcost3}")

    args = rbx.binding_inputs(dev, b=b_w, n=n_w)
    ms = {}
    for s in E7_SPLIT:
        got, ms[s] = res[2][s]
        plain = lambda: rb.rollout_bisect_reference(s, *args, population=p_w, iterations=i_w)
        dpose, dcost = _bisect_check("wide", s, got, plain(), E7_WIDE_TOL)
        plain_ms = _events_ms(plain, 1)
        bms, by = _bisect_bound(s, args, p_w, i_w)
        variants[f"stage{s}_wide"] = dict(ms=ms[s], plain_ms=plain_ms, max_abs_err=max(dpose, dcost),
                                         bound_ms=bms, bound_by=by, library_ms=None)
        print(f"[phase 6g] stage {s} ({rb.cost_kind(s)}; B={b_w} P={p_w} N={n_w} I={i_w}, binding "
              f"inputs): max |dpose| {dpose:.3e}, |dcost| {dcost:.3e}; kernel {ms[s]:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, {100 * bms / ms[s]:.1f}% of it)")
    for tag, inputs in (("binding", args), ("flat", _flat_inputs(args))):
        first = _bisect_first_evaluations(tag, inputs, p_w)
        variants[f"stage3_no_step_{tag}"] = dict(max_abs_err=first)
        _bisect_witness(tag, inputs, p_w)
    split = (ms[1], ms[2] - ms[1], ms[3] - ms[2])
    print(f"[phase 6g] K2's time split (B={b_w} P={p_w} N={n_w} I={i_w}): draws+update / bind / "
          f"score = {split[0]:.4f} / {split[1]:.4f} / {split[2]:.4f} ms; stage 3 {ms[3]:.4f} ms "
          f"beside K2 (phase 5b) {k2_ms:.4f} ms")
    entry = _study_entry("rollout_bisect", "rollout_bisect.cu", "experiments/rollout_bisect.py:219",
                         launches, variants, "stage3_wide")
    entry["split_ms"] = dict(zip(("draws_update", "bind", "score"), split))
    entry["k2_ms"] = k2_ms
    return entry


def phase_studies(k2_ms):
    """6: the ported TPU studies and probes, given K2's time from phase 5b.
    Returns their kernels-line entries."""
    import torch

    dev = torch.device("cuda")
    entries = []
    for phase in (phase_kernel_variants, phase_rollout_score_variants, phase_pallas_variants,
                  phase_scatter, phase_io_probe, phase_mosaic_probe,
                  lambda d: phase_rollout_bisect(d, k2_ms)):
        t0 = time.perf_counter()
        entries.append(phase(dev))
        print(f"[phase 6] {entries[-1]['name']}: wall {time.perf_counter() - t0:.1f} s")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # The plain versions' matrix products run in full float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    worst = phase_kernel()
    phase_paths()
    node, lg, launches = phase_main()
    worst_main, ms, plain_ms, bnd = phase_main_kernel(node, lg)
    world = batch_world(BATCH, torch.device("cuda"))
    worst_small = phase_batch_kernels(world)
    timed = phase_batch(world)
    timed.update(phase_batch_small(world))
    tpu = "ndtpso_slam_tpu/ops/"
    kernels = [_entry("rollout_local", SRC + "rollout_local.cu", tpu + "pallas_rollout.py:551",
                      launches, max(worst, worst_main), ms, plain_ms, bnd)]
    for name, source, replaces in (
        ("rollout_local_turbo", "rollout_local.cu", "pallas_rollout.py:618"),
        ("rollout", "rollout.cu", "pallas_rollout.py:111"),
        ("rollout_bf16", "rollout.cu", "pallas_rollout.py:262"),
        ("rollout_turbo", "rollout.cu", "pallas_rollout.py:148"),
        ("score", "score.cu", "pallas_score.py:41"),
    ):
        n_launch, k_ms, p_ms, wide_err, k_bnd = timed[name]
        kernels.append(_entry(name, SRC + source, tpu + replaces, n_launch,
                              max(worst_small[name], wide_err), k_ms, p_ms, k_bnd))
    kernels.extend(phase_studies(timed["rollout"][1]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
