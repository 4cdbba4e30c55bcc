"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device and build: requires a CUDA device, prints the card's name and power
   limit (nvidia-smi), builds the three kernel libraries from csrc/ (one nvcc
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
    from ndtpso_slam_tpu_torch.ops import _build, rollout, rollout_local, score

    t0 = time.perf_counter()
    paths = _build.build(rollout_local.LIB, rollout.LIB, score.LIB)
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
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    print(f"[phase 4] kernel vs plain on the next solve's inputs: max |dpose| "
          f"{dpose:.3e} max |dcost| {dcost:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
    return max(dpose, dcost), ms, plain_ms


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
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.ops import score as sc

    return dict(rollout=ro.pso_rollout, rollout_local=rl.pso_rollout_local,
                score=sc.fused_bound_scores)


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


def phase_batch(world):
    """5b: solve_batch at full width.  Returns {kernel name: (launches, ms,
    plain ms, max abs err)} for the kernels it times."""
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
        else:
            packed = _packed(world)
            kw = dict(early_exit=ee, rng_mode="native" if "turbo" in mode else "threefry")
            kern = lambda: ro.pso_rollout(*packed, **kw)
            plain = lambda: ro.pso_rollout_reference(*packed, **kw)
            derr = max(_compare_wide(mode, kern(), plain(), world["true"]))
            shape = f"B={b} N=384 P={cfg.population} I={cfg.iterations} ee={ee}, one solve_batch"
        ms = _events_ms(kern, 3)
        plain_ms = _events_ms(plain, 1)
        print(f"[phase 5b] {kname} kernel vs plain ({shape}): max abs err {derr:.3e}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
        launches_main = counts["score" if kname == "score" else "rollout"]
        out[kname] = (launches_main, ms, plain_ms, derr)
    return out


def phase_batch_small(world):
    """5c: the other batch modes at B=16, the same widths: finite results
    and launch counts; rollout_bf16 and rollout_local_turbo against their
    plain versions, timed.  Returns {kernel name: (launches, ms, plain ms,
    max abs err)}."""
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
        elif mode == "rollout_local_turbo":
            packed = _packed(small, local=True)
            kern = lambda: rl.pso_rollout_local(*packed, rng_mode="native")
            plain = lambda: rl.pso_rollout_local_reference(*packed, rng_mode="native")
            derr = max(_compare_wide(mode, kern(), plain(), small["true"]))
            name = "rollout_local_turbo"
            lc = counts["rollout_local"]
        else:
            continue
        ms = _events_ms(kern, 3)
        plain_ms = _events_ms(plain, 1)
        print(f"[phase 5c] {name} kernel vs plain (B={BATCH_SMALL} N=384 P={cfg.population} "
              f"I={cfg.iterations}): max abs err {derr:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms")
        out[name] = (lc, ms, plain_ms, derr)
    return out


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
    worst_main, ms, plain_ms = phase_main_kernel(node, lg)
    world = batch_world(BATCH, torch.device("cuda"))
    worst_small = phase_batch_kernels(world)
    timed = phase_batch(world)
    timed.update(phase_batch_small(world))
    src = "ndtpso_slam_tpu_torch/csrc/"
    tpu = "ndtpso_slam_tpu/ops/"
    kernels = [{
        "name": "rollout_local",
        "route": "cuda",
        "source": src + "rollout_local.cu",
        "replaces": tpu + "pallas_rollout.py:551",
        "launches": launches,
        "max_abs_err": max(worst, worst_main),
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    for name, source, replaces in (
        ("rollout_local_turbo", "rollout_local.cu", "pallas_rollout.py:618"),
        ("rollout", "rollout.cu", "pallas_rollout.py:111"),
        ("rollout_bf16", "rollout.cu", "pallas_rollout.py:262"),
        ("rollout_turbo", "rollout.cu", "pallas_rollout.py:148"),
        ("score", "score.cu", "pallas_score.py:41"),
    ):
        n_launch, k_ms, p_ms, wide_err = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": tpu + replaces,
            "launches": n_launch, "max_abs_err": max(worst_small[name], wide_err),
            "ms": k_ms, "plain_ms": p_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
