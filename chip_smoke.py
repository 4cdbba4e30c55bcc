"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device and build: requires a CUDA device, prints the card's name and power
   limit (nvidia-smi), builds the rollout kernel from csrc/.
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
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    t0 = time.perf_counter()
    path = rl.build()
    print(f"[phase 1] built {path} in {time.perf_counter() - t0:.2f} s")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_device()
    worst = phase_kernel()
    phase_paths()
    node, lg, launches = phase_main()
    worst_main, ms, plain_ms = phase_main_kernel(node, lg)
    print(json.dumps({"kernels": [{
        "name": "rollout_local",
        "route": "cuda",
        "source": "ndtpso_slam_tpu_torch/csrc/rollout_local.cu",
        "replaces": "ndtpso_slam_tpu/ops/pallas_rollout.py:551",
        "launches": launches,
        "max_abs_err": max(worst, worst_main),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
