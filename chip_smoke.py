"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device and build: requires a CUDA device, prints the card's name and power
   limit (nvidia-smi), builds the eight kernel libraries from csrc/ (one nvcc
   each, all at once) and prints what ptxas reports of each kernel
   instantiation (its name, registers, spills).

K1 (csrc/rollout_local.cu) and K2 (csrc/rollout.cu) run one solve per
thread-block cluster of C CTAs, C chosen by ops/_build.py:choose_cluster
(the fewest waves, then the largest C: 8 at B <= 15, 4 at B=16 on an H100);
their kernels-line entries carry the C each ran with (`cluster`).
2. Kernel against its plain PyTorch version: B=3 solves, N=384 points,
   P in {50, 200}, 10 iterations, on a small synthetic map.
3. Kernel path against the plain path: 8 scans of SlamNode with
   cost_mode="rollout_local" and again with "local_exact".
4. Main path at scan.launch scale: a 300 m frame of 0.5 m cells (360,000
   cells), 100-slot window, 50 particles x 30 iterations, 384 padded beams,
   over the 50-scan synthetic log of bench.py's SLAM workload; the per-robot
   trajectory gate of bench.py (mean error < 0.35 m, max < 0.7 m) and the
   kernels' launch counts (K1 once an aligned scan, the map update's
   ndt_ingest once a scan); the same log with the occupancy raster on
   (build_og, 3000 x 3000 int8): the step p50/p95 beside a raster-off run
   just before it, the launch count, the poses bit-equal to the raster-off
   run (both under deterministic algorithms), and where the incremental
   raster differs from a dense pass
   over the final map (ROADMAP R1: the count of sub-cells and blocks, the
   largest difference); then K1 against its plain version, both timed, on
   the inputs of the solve that run would make next, and ndt_ingest against
   its plain version on the map update it would make next; then the
   log's last 10 scans fed again under torch.profiler (kernels per scan,
   device busy share, K1's share).
5. Batch scan matching (parallel/mesh.py:solve_batch), bench.py's ``batch``
   workload:
   a. each kernel against its plain version on small inputs: the frozen
      rollout kernel in rollout, rollout_bf16 and rollout_turbo at B=3,
      N=384, P in {50, 200, 4096}, I=10, and with early exit 2; the turbo
      branch of the exact rollout kernel at B=3, P=50, and its Threefry
      branch at B=3, P=8192 (16 particles per thread); the global routes
      (particle state in global scratch) of the frozen rollout kernel at
      P=8192 and 16,384 and of the exact one at P=16,384; the scoring
      kernel at B=4, P=4096, N=384 on binds of the 5b workload, held to
      the float64 value of its sum;
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
      versions as in 5b, with the clusters of each size the card holds at
      once at their shapes (cudaOccupancyMaxActiveClusters);
   d. the global routes through solve_batch: rollout at B=256, P=8192 and
      rollout_local_turbo at B=16, P=16,384 (I=50): the accuracy gate,
      the one launch, the route, and each kernel against its plain version
      on the call's own inputs, timed.  The map is built on the card with
      atomic scatter-adds, so its last bits change from run to run, and on
      some maps (18 of 176, k2_near_tie.py) one of K2's solves meets two
      particles whose float32 costs tie in the plain version's sum order
      and not in K2's.  Where a solve parts, the first iteration whose
      global best differs is found (K2 rerun with 1, 2, .. I iterations);
      it must be such a tie: the plain version evaluated K2's pick a, a
      was not strictly below the plain version's pick b there, and the two
      plain costs lie no further apart than K2's and the plain version's
      costs of a, which must agree within the tolerance.  The plain
      version is then run again taking K2's side of each tie (a's cost set
      to K2's) and the kernel is held to that run with the same tolerances,
      up to TIE_ROUNDS ties.
6. The variant studies ported from the TPU (ndtpso_slam_tpu_torch/experiments/),
   each driven once through the run() its entry point calls, at the TPU
   script's shapes, with the launch counts set to 0 just before and read
   just after; then every variant's kernel output held against its plain
   version, timed, and its bound:
   a. kernel_variants: the six scoring configurations, B=64, N=384, P=4096;
   b. rollout_score_variants: the five score-block variants, B=64, I=50,
      c and carry, and their time at I and I/2; per variant the cluster
      size C its launch chose, its CTAs and the SMs they ran on;
   c. pallas_variants: the nine variant/tile pairs inside pso_solve_batch
      at B=32, P=4096, I=50, beside the plain baseline (solves/s, cost
      maxdiff, median pose error; a variant less accurate than the
      baseline is printed as a finding), each kernel on the population
      call's own inputs against its plain version and float64;
   d. scatter_unique_ab: the row scatter at W=2 over 2.88 M rows and at
      W=128 over 360,001 rows, bit-equal to index_copy_ on unique ids and
      to its plain version on duplicate ids, beside the library calls; then
      at W=2 (one and three fields), W=128 and at M = 1,000,000 (more blocks
      than the card holds at once): the launch shape, bit-equal to the plain
      version, and the kernel's and index_copy_'s times three ways (CUDA
      events back to back, device busy and device operations per call, the
      host time until a call returns);
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
      their times, and what K2 spends beyond stage 3 (K2-only), from K2's
      time in phase 5b; at that shape, stage 3
      with no PSO step held to one evaluation's sum order on the binding
      inputs and on a flat landscape, and a witness printed: after 0-50
      steps, kernel against plain version and plain float32 against
      float64.
7. Relocalization:
   a. bench.py's multiswarm workload (bench.py:919-1009; the 5b map, K=16
      hypotheses, P=4096, I=50, N=384): multi_swarm_rollout in f32 and
      bf16 (one K2 launch at B=16) and multi_swarm_solve through the
      scoring kernel (exchange every 5): bench.py's gate (< 0.1 m / 0.02
      rad), relocalizations/s, the launches, and K2 against its plain
      version on the call's inputs in its cluster's order, timed, with its
      bound, its C and its waves;
   b. the cluster chooser: K2 f32 and bf16 and K1 turbo at B=16, the
      chosen C against C=8 (A B B A), and K1's B=1 host time through the
      cached choice beside phase 4's step p50;
   c. bench.py's recovery workload at --full-scale (bench.py:626-770): one
      kidnapped scan at scan.launch scale with the default RecoveryConfig
      and a rollout_local align: recoveries == 1 and bench.py's error gate
      (< 0.3 m, 0.3 m, 0.1 rad) at bench.py's key, the launches, the same
      step at seven other keys (reported, not gated: ROADMAP R5), the
      event latency against one 10 Hz period, one event profiled, the peak
      memory, the healthy step with recovery on and off (poses bit-equal),
      the scoring kernel on the event's last call against its plain
      version and float64, timed, and each reloc_step launch's operands
      (csrc/reloc_step.cu: the refine swarms' glue) against the PyTorch
      binder and features at the same state (the mask bit for bit, w and
      the features within RELOC_W_RTOL / RELOC_PHI_ATOL), the state after
      each fold and each solve's result against pso_solve_batch fed the K3
      costs the kernel folded (bit for bit), a solve through it against
      the plain pso_solve_batch solve on the card (K3 in both; pose and
      cost bit for bit), its device time per launch and per event, and the
      two solves timed.

8. The whole node (every option and container of the JAX node's single
   session):
   a. tests/data/realistic.bag read by the port's own reader (60 scans x 540
      beams), through SlamNode at tests/test_realdata.py's configuration
      (48 m frame, 1 m cells, 8 slots, P=50, I=30, from the odometry's
      first pose) in fast_local and in rollout_local (K1, 640 padded
      beams): max error < 0.3 m against realistic_gt.npy and a final error
      below the odometry's, step p50/p95, K1's launches per scan; then K1
      against its plain version on the next solve's inputs, timed;
   b. a sparse ring at scan.launch scale: phase 4's log and configuration
      with ring_rows from 16,384, doubled until no cell overflows, under
      deterministic algorithms: poses bit-equal to the dense run's, phase
      4's gate, ring_used and ring_overflow, and the peak device memory of
      the dense and the sparse run;
   c. the stencil patch covering every scan (patch_range_m = the log's
      range_max): poses bit-equal to the unpatched run's, the patch side;
   d. prefer_frontal_points at scan.launch scale in rollout_local: phase
      4's gate, K1's launches, the beams kept per scan;
   e. GLIR: the node in local_exact + glir on realistic.bag under
      deterministic algorithms (max error < 1.0 m), solve_batch(optimizer=
      "glir") at B=16 in fast (solve 0 its B=1 call), and GLIR with
      rollout_local refused;
   f. the export bundle of a realistic.bag run with the raster and the map
      image on (names, sizes, PNGs decoded), and 8b's sparse run
      checkpointed after 25 scans, restored into a fresh node and run to
      the end: poses bit-equal to the uninterrupted run's.

9. Fleets and sessions (parallel/fleet.py, parallel/sessions.py, the
   node's MultiSessionNode):
   a. bench.py's 8-robot flat fleet at deployment scale
      (slam_fullscale_8robots_r8192_flat_rollout_local, bench.py:400-487):
      make_log(seed=2 + r, 50 scans, world_size=50) for r < 8, 300 m / 0.5 m
      / 100 slots with a sparse ring of 8,192 rows, P=50, I=30, N=384,
      rollout_local, keys [3, 9 + r], through run_offline_fleet: the
      per-robot gate of phase 4, exactly 49 K1 launches (B=8 each) and 2
      row_scatter launches per step (the wrappers' own counts), aggregate
      scans/s, the pool's step p50/p95, device kernels per fleet step, peak
      memory; the row_scatter calls of one step against their plain version
      and the 6 indexed assignments they replace; each robot's poses
      against its solo run under deterministic algorithms (bit-equal where
      the launches ran at the solo launches' cluster size, else phase 3's
      tolerance, the reason printed), and again over 8 scans in rollout (K2
      at B=8); K1 at B=8 against its plain version, 8 B=1 launches and its
      bound;
   b. two sensors' .npz logs (10 Hz and 5 Hz) with launch/lidar_front.json
      and lidar_back.json through `python -m ndtpso_slam_tpu_torch.node`
      with two --scanlog (a subprocess, --deterministic): exit 0, the
      duo-s0.* and duo-s1.* bundles, each pose CSV equal to a solo SlamNode
      of seed + 101·i under the same rule;
   c. 7c's kidnap in a SlamSessionPool of 8 sessions with recovery on:
      robot 3 gets the kidnapped scan, the others the healthy one; one
      accepted recovery within 7c's gate, the other robots' map rows
      bit-equal before and after the escalation, the launches (K1 once, K3
      and reloc_step 44 times each, row_scatter 4), the event's wall time
      against the 100 ms period, the escalation at 7c's other keys
      reported.

10. Multi-device and multi-process (parallel/runtime.py, distributed.py,
    the sharded entry points of mesh.py, multi_swarm.py and fleet.py), as
    two ranks of this script (``chip_smoke.py --rank DIR``, NDTPSO_*
    variables) over gloo on the one card (NCCL refuses two ranks on one
    GPU), laid out as 2 hosts x 1 chip, each waiting on its own timeout;
    read two-rank rates as the multi-process path's overhead, not scaling:
    a. the sharded solver at 5b's width (B=256 as 2 x 128) in rollout (K2),
       rollout_local_turbo (K1) and fast_fused (K3): the gathered rows
       against one process's solve_batch (bit-equal where the kernel ran at
       one cluster size both ways, else 5a's tolerances, the reason
       printed), the launches, each rank's kernel against its plain version
       on its first rows and timed alone on the card, per-rank wall time;
    b. the same at world 1 over NCCL in this process, bit-equal;
    c. 7a's relocalization as 2 x 1: multi_swarm_solve (K3) with a merge
       within a rank every 2 iterations and across ranks every 4
       (__graft_entry__.py:163-171), bit-equal to all K swarms in one
       process at that cadence, and multi_swarm_rollout (K2) with the exact
       winners gathered over ranks, against the one-process call;
    d. the exact map merge at scan.launch scale (300 m, 0.5 m, 100 slots),
       phase 4's 50-scan log at its true poses, each rank ingesting half of
       each scan: integer fields and flags bit-equal to one process
       ingesting everything, cur_sum within 1e-4 and g_sum within 1e-5,
       every rank's map bit-equal (checksums), the bytes and time of each
       merge;
    e. 9a's 8-robot fleet through run_offline_fleet_sharded, 4 robots per
       rank (K1 at B=4, E4 on each rank's flat build, each held to its
       plain version): each robot against the unsharded fleet under the
       cluster rule, phase 4's gate per robot;
    and each collective's calls by backend and the device of its tensors.

11. The acceptance gate of BASELINE.json against the C++ golden reference
    (native/golden/golden.cpp, built with the host C++ compiler into
    ndtpso_slam_tpu_torch/_build/ through utils/native.py): pose RMSE <=
    1e-3 m / 1e-3 rad under the same particle count, iteration budget and
    cell size; the golden runs on the host, on the same float32 points:
    a. config 1 at B=64 (tests/test_parity_golden.py's recipe for seeds
       0-63: a 360-beam reference scan on a 50 m box world, three jittered
       observations of it into the port's map built on the card and into
       the golden's, a query scan at a random true pose; P=50, I=50,
       deviation 0.4/0.4/0.08, key (seed, seed + 100)): solve_batch in
       rollout_local (K1 as the main path runs it, one launch at B=64, its
       25-cell stencil: a particle that moves a point more than 2 cells
       scores it 0, so its RMSE to the golden is reported, not gated;
       ROADMAP §3, R9), K1 again with an 81-cell stencil (radius 4, the
       exact cost on this workload) and solve_batch in exact (the plain
       route), these two held to the gate; K1 against its plain version in
       the order of its cluster at both radii, timed at radius 2, and its
       bound;
    b. the main path over tests/test_parity_golden.py's 12-scan log (64 m,
       1 m cells, 8 slots of 50 points, P=50, I=30): run_offline in
       rollout_local (K1 once per scan after the first) against
       golden_slam_run, the JAX test's accuracy condition (RMSE to the
       ground truth < 1.5 x the golden's + 1e-3);
    c. the same log through run_offline in exact on float64 CUDA tensors:
       the accuracy condition, the largest difference to the golden and the
       first scan that differs, reported: CUDA's double sin/cos/exp are not
       glibc's, so bit equality is not held there (tests/test_torch_golden.py
       holds the CPU loop to it).

Each kernel's entry in the kernels line carries its bound: the larger of
the bytes its function must move over the HBM rate and its operations
over the peak rate of the pipe they need (below).

The last two lines of standard output are a JSON object describing each
kernel, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
    from ndtpso_slam_tpu_torch.ops import (_build, ndt_ingest, probes, reloc_step, rollout,
                                           rollout_bisect, rollout_local, row_scatter, score,
                                           score_variants)

    t0 = time.perf_counter()
    paths = _build.build(rollout_local.LIB, rollout.LIB, score.LIB, score_variants.LIB,
                         row_scatter.LIB, probes.LIB, rollout_bisect.LIB, ndt_ingest.LIB,
                         reloc_step.LIB)
    print(f"[phase 1] built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for path in paths:
        log = path.with_suffix(".log")
        for line in _ptxas_summary(log.read_text() if log.exists() else ""):
            print(f"[phase 1] {path.stem.split('-')[0]}: {line}")


def _ptxas_summary(log):
    """One line per kernel instantiation of an nvcc -Xptxas -v log: its
    name with its mangled template arguments, registers, stack frame and
    spill bytes."""
    import re

    def short(mangled):
        """The kernel's own name (the last <length><name> of the mangled
        nested name) and its template arguments, as mangled."""
        i, name = (re.match(r"_ZN?", mangled) or re.match("", mangled)).end(), None
        while (d := re.match(r"\d+", mangled[i:])) is not None:
            start = i + d.end()
            name, i = mangled[start:start + int(d.group())], start + int(d.group())
        if name is None:
            return mangled
        targs = re.match(r"(I\w*?E)?E", mangled[i:])
        return name + ((targs.group(1) or "") if targs else "")

    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # the kernel's name and template arguments, as mangled
            name = short(m.group(1))
        elif "spill" in line:
            frame = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, {frame}")
            name, frame = None, ""
    return out


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


def _pack_local(snaps, mc, guesses, points, valid, radius=None):
    """K1's packed inputs for B solves on per-solve snapshots, as
    models/solve.py:solve_rollout_mode packs them, with a stencil of
    (2 radius + 1)^2 cells (default: the cost modes' radius)."""
    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    radius = cost.DEFAULT_STENCIL_RADIUS if radius is None else radius
    return rl.pack_rollout_local_inputs(
        cost.bind_neighborhood(guesses, snaps, points, valid, mc, radius=radius), points)


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


def _run_node(cfg, lg, steps=None, node=None):
    """A node of NodeConfig cfg (or the given node) over the log's scans
    (``steps``, default all): (node, step seconds, total seconds, K1
    launches, peak device memory of the run beyond what was allocated
    before it), every launch count set to 0 just before the run and K1's
    read just after."""
    import torch

    from ndtpso_slam_tpu_torch.node import SlamNode
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    node = SlamNode(cfg, verbose=False) if node is None else node
    step_s = []
    _reset_counts()
    t0 = time.perf_counter()
    for i in range(len(lg.ranges)) if steps is None else steps:
        odom = None if lg.odoms is None else lg.odoms[i]
        ts = time.perf_counter()
        node.process_scan(lg.ranges[i], lg.angle_min, lg.angle_increment,
                          lg.range_max, timestamp=float(lg.timestamps[i]), odom=odom)
        step_s.append(time.perf_counter() - ts)  # ends in the pose's copy to the host
    total = time.perf_counter() - t0
    return node, step_s, total, rl.pso_rollout_local.LAUNCHES, torch.cuda.max_memory_allocated() - base


def _main_cfg(lg, **over):
    """Phase 4's node configuration (scan.launch scale, rollout_local)."""
    from ndtpso_slam_tpu_torch.node import NodeConfig

    return NodeConfig(frame_size_m=300.0, cell_side_m=0.5, window_slots=100,
                      pso_iterations=30, pso_population=50, max_beams=384,
                      cost_mode="rollout_local", init_pose=tuple(lg.poses[0]), **over)


def _run_main(lg, build_og, **over):
    """Phase 4's node over the log (``_run_node``), with the raster on or
    off and NodeConfig overrides ``over``."""
    return _run_node(_main_cfg(lg, build_og=build_og, **over), lg)


def _percentiles(step_s):
    aligned = np.array(step_s[1:]) * 1e3  # the first scan is not aligned
    return np.percentile(aligned, 50), np.percentile(aligned, 95)


def phase_main():
    from ndtpso_slam_tpu_torch.io import synthetic

    lg = synthetic.make_log(seed=2, n_scans=50, n_beams=360, world_size=50.0)
    node, step_s, total, launches, peak = _run_main(lg, build_og=False)
    counts = _read_counts()
    poses = np.stack(node.poses)
    err = np.hypot(poses[:, 0] - lg.poses[:, 0], poses[:, 1] - lg.poses[:, 1])
    check(np.isfinite(poses).all() and poses.shape == (50, 3), "poses not finite [50, 3]")
    aligns = len(lg.ranges) - 1  # the first scan is not aligned
    check(launches == aligns, f"kernel launches {launches} != aligns {aligns}")
    # The map update: one ndt_ingest launch a step, the first scan's too.
    want = {n: {"rollout_local": aligns, "ndt_ingest": len(lg.ranges)}.get(n, 0) for n in counts}
    check(counts == want, f"launches {counts}, expected {want}")
    check(err.mean() < GATE_MEAN_M and err.max() < GATE_MAX_M,
          f"trajectory gate: mean {err.mean():.4f} m, max {err.max():.4f} m")
    p50, p95 = _percentiles(step_s)
    print(f"[phase 4] 300 m / 0.5 m / 100 slots / P=50 I=30 / N=384, 50 scans: "
          f"mean err {err.mean():.4f} m, max {err.max():.4f} m; "
          f"{len(lg.ranges) / total:.2f} scans/s; aligned-step latency "
          f"p50 {p50:.3f} ms p95 {p95:.3f} ms; "
          f"peak device memory {peak / 2**30:.3f} GiB; kernel launches {launches}, ndt_ingest "
          f"{counts['ndt_ingest']}")
    return node, lg, launches, p50, counts["ndt_ingest"]


# Phase 4's raster runs: off, on, on, off, off, on; the step p50/p95 of
# each side is the median over its runs (one run's p50 moves by ms on a
# shared host).
OG_ORDER = (False, True, True, False, False, True)


def phase_main_og(node_off, lg):
    """Phase 4 again with the occupancy raster on (3000 x 3000 int8 at
    0.1 m), alternating with runs without it (OG_ORDER): the K1 launches,
    the step p50/p95 of both, the poses bit for bit (the raster is an
    output only), and R1: where the incremental raster differs from a
    dense pass over the final map."""
    import torch

    from ndtpso_slam_tpu_torch.models import occupancy

    pct = {False: [], True: []}
    for og_on in OG_ORDER:
        run = _run_main(lg, build_og=og_on)
        pct[og_on].append(_percentiles(run[1]))
        if og_on:
            node, step_s, total, launches, peak = run
            check(launches == len(lg.ranges) - 1, f"raster on: kernel launches {launches}")
        del run
    poses_on, poses_off = np.stack(node.poses), np.stack(node_off.poses)
    moved = float(np.abs(poses_on - poses_off).max())
    # The map update is one kernel that adds in index order, but other ops
    # of the step may use atomics on CUDA; the bit-for-bit comparison runs
    # both with deterministic algorithms.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = [np.stack(_run_main(lg, build_og=og)[0].poses) for og in (False, True)]
    finally:
        torch.use_deterministic_algorithms(False)
    check(np.array_equal(det[0], det[1]), "raster on moved a pose (deterministic runs): max "
          f"|dpose| {np.abs(det[0] - det[1]).max():.3e}")
    og = node.state.og
    cfg = node.slam_cfg
    dense = occupancy.og_update(occupancy.init_og(cfg.map, cfg.og, og.og.device), node.state.map,
                                cfg.map, cfg.og)
    diff = og.og.to(torch.int16) - dense.og.to(torch.int16)
    stale = diff != 0
    h, w, per = occupancy.og_dims(cfg.map, cfg.og)
    blocks = stale.reshape(h // per, per, w // per, per).any(dim=3).any(dim=1)
    n_stale, n_blocks = int(stale.sum()), int(blocks.sum())
    largest = int(diff.abs().max())
    bbox = [int(getattr(og, k)) for k in ("min_x", "max_x", "min_y", "max_y")]
    check(int(torch.count_nonzero(og.og)) > 0 and bbox[0] <= bbox[1], "raster on: empty raster")
    (on50, on95), (off50, off95) = (np.median(pct[k], axis=0) for k in (True, False))
    runs = lambda k: ", ".join(f"{a:.3f}" for a, _ in pct[k])
    print(f"[phase 4] raster on ({h} x {w} int8, 0.1 m), {len(pct[True])} runs each way "
          f"alternating: aligned-step latency p50 {on50:.3f} ms p95 {on95:.3f} ms (p50 by run "
          f"{runs(True)}); raster off p50 {off50:.3f} ms p95 {off95:.3f} ms ({runs(False)}); "
          f"peak device memory {peak / 2**30:.3f} GiB; kernel launches {launches}; poses "
          f"bit-equal to the raster-off run under deterministic algorithms (the timed pair "
          f"differs by {moved:.3e}); {int(torch.count_nonzero(og.og))} sub-cells nonzero, bbox "
          f"{bbox}; R1: incremental vs dense over the final map: {n_stale} sub-cells in "
          f"{n_blocks} blocks differ, largest |difference| {largest}")
    phase_main_profile(node, lg, tag=" with the raster on")


# Phase 4's profiled window: the log's last scans fed again after the gated
# run (the map and the pose carry on), one torch.profiler window over them.
PROFILE_SCANS = 10


def phase_main_profile(node, lg, tag="", phase="[phase 4]"):
    """Phase 4's step under torch.profiler: device kernels per scan, device
    busy share of the wall time, and K1's share of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx = range(len(lg.ranges) - PROFILE_SCANS, len(lg.ranges))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in idx:
            node.process_scan(lg.ranges[i], lg.angle_min, lg.angle_increment, lg.range_max,
                              timestamp=float(lg.timestamps[i]))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILE_SCANS
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in kern) / 1e3 / PROFILE_SCANS
    k1 = sum(dev_us(e) for e in kern if "rollout_local_kernel" in e.key) / 1e3 / PROFILE_SCANS
    launches = sum(e.count for e in kern) / PROFILE_SCANS
    # A window the profiler recorded nothing in (ROADMAP T1) prints as such.
    k1_share = f"{100 * k1 / busy:.1f}%" if busy > 0 else "none recorded"
    print(f"{phase} profiled{tag}, {PROFILE_SCANS} more scans: {launches:.1f} device kernels per scan, "
          f"busy {busy:.3f} of {wall:.3f} ms per scan ({100 * busy / wall:.1f}%), K1 {k1:.4f} ms "
          f"({k1_share} of device time)")


def _events_ms(fn, reps):
    """ms per call over reps calls after a warm one (CUDA events)."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import time_ms

    return time_ms(fn, reps, torch.device("cuda"))


def phase_main_kernel(node, lg, tag="[phase 4]"):
    """Kernel vs plain version, compared and timed, on the inputs of the solve
    the main path would run next (B=1, N=384, P=50, I=30 at phase 4): the
    final map, the final pose as guess, the last scan."""
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
    cluster = rl.pso_rollout_local.LAST_CLUSTER
    bnd = _rollout_local_bound(sten, pts, cfg.pso.population, [cfg.pso.iterations])
    print(f"{tag} kernel vs plain on the next solve's inputs (N={pts.shape[1]}): max |dpose| "
          f"{dpose:.3e} max |dcost| {dcost:.3e}; kernel {ms:.4f} ms (one cluster of {cluster} "
          f"CTAs), plain {plain_ms:.3f} ms, "
          f"bound {bnd[0]:.6f} ms ({bnd[1]}; one solve, latency-bound)")
    return max(dpose, dcost), ms, plain_ms, bnd, cluster, args


# The map update's float fields in the cells where the kernel and the
# deterministic index_add_ sum in other orders: the largest gap, relative
# to the field's largest magnitude there (1.536e-06 on phase 4's update).
INGEST_REL_GAP = 1e-5


def phase_ingest(node, lg, launches, tag="[phase 4]"):
    """The map update's kernel (ops/ndt_ingest.py) against its plain version
    (ndt_map.ingest_scan_reference, deterministic) on the update the main
    path would run next: the final map, pose and previous ids, the last
    scan.  Ids, integer and bool fields equal in every real row, float
    fields bit for bit in every real row whose open-slot sums both add in
    one order, and within INGEST_REL_GAP, finite where the plain version's
    are, in the others (tests/test_torch_ingest.py: the deterministic
    index_add_ sums a cell's beams of the scan before it adds them); then
    timed.  ``launches``: the kernel's launches over phase 4's run.
    Returns the kernels-line entry."""
    import dataclasses

    import torch

    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.ops import ndt_ingest as ni

    cfg, st = node.slam_cfg, node.state
    c = cfg.map.num_cells
    scan = scan_mod.load_laser(lg.ranges[-1], lg.angle_min, lg.angle_increment, lg.range_max,
                               cfg.scan, cfg.map)
    args = (cfg.map, st.pose, scan.points, scan.valid, st.prev_ids)
    clone = lambda: ndt_map.NdtMapState(**{f.name: getattr(st.map, f.name).clone()
                                           for f in dataclasses.fields(st.map)})
    a, b = clone(), clone()
    before = ni.ndt_ingest.LAUNCHES
    ids = ndt_map.ingest_scan(a, *args)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ids_b = ndt_map.ingest_scan_reference(b, *args)
    finally:
        torch.use_deterministic_algorithms(False)
    check(ni.ndt_ingest.LAUNCHES - before == 1, "ndt_ingest: not one launch for the update")
    check(torch.equal(ids, ids_b), "ndt_ingest: ids differ from the plain version's")
    hits = torch.bincount(ids.long(), minlength=c + 1)[:c]
    reordered = (st.map.cur_count[:c] > 0) & (hits >= 2)
    # Where the orders differ: each float field's largest gap, and that gap
    # relative to the field's largest magnitude over those cells.
    worst, worst_abs, differ, finite = 0.0, 0.0, [], []
    for name, _, _ in ni.FIELDS:
        x, y = getattr(a, name)[:c], getattr(b, name)[:c]
        if x.is_floating_point():
            xr, yr = x[reordered], y[reordered]
            ok = torch.isfinite(yr)
            if not torch.equal(torch.isfinite(xr), ok):
                finite.append(name)
            if bool(ok.any()):
                gap = float((xr[ok] - yr[ok]).abs().max())
                worst_abs = max(worst_abs, gap)
                worst = max(worst, gap / (float(yr[ok].abs().max()) or 1.0))
            x, y = x[~reordered].view(torch.int32), y[~reordered].view(torch.int32)
        if not torch.equal(x, y):
            differ.append(name)
    check(not differ, f"ndt_ingest: fields differ from the plain version's: {differ}")
    check(not finite, f"ndt_ingest: finite on one side only, in the re-ordered cells: {finite}")
    check(worst <= INGEST_REL_GAP, f"ndt_ingest: re-ordered cells {worst:.3e} of a field's "
          f"magnitude from the plain version's (limit {INGEST_REL_GAP:.0e})")
    del a, b
    t = clone()
    kernel = _time_split(lambda: ndt_map.ingest_scan(t, *args), 50, 1)
    graph_ms = _graph_ms(lambda: ndt_map.ingest_scan(t, *args))
    plain_ms = _events_ms(lambda: ndt_map.ingest_scan_reference(t, *args), 20)
    del t
    n = scan.points.shape[0]
    d_ingest = int(torch.unique(ids[ids < c]).numel())
    both = torch.cat([ids, st.prev_ids])
    d_build = int(torch.unique(both[both < c]).numel())
    # The beams' points, masks and both id lists; each built cell's fields
    # read once (15 floats, 5 ints) and written once (20 floats, 5 ints, a
    # bool); each hit cell's created and built flags.
    item = scan.points.element_size()
    bms, by = bound(n * (2 * item + 1 + 4 + 4) + d_build * (35 * item + 10 * 4 + 1) + 2 * d_ingest)
    ms = kernel["ms"]
    print(f"{tag} ndt_ingest vs plain on the next update (N={n}, {d_ingest} cells hit, {d_build} "
          f"built, {int(reordered.sum())} summed in the CPU's order only, largest gap there "
          f"{worst_abs:.3e}, {worst:.3e} of a field's magnitude, limit {INGEST_REL_GAP:.0e}; "
          f"{launches} launches over phase 4's 50 steps): kernel {ms:.4f} ms back to back "
          f"(events), device busy {kernel['device_ms']:.4f} ms in {kernel['device_ops']:.1f} operations a "
          f"call, graph "
          f"{graph_ms:.4f} ms a call, host {kernel['host_us']:.1f} us; plain {plain_ms:.3f} ms; "
          f"bound {bms:.6f} ms ({by}, {100 * bms / kernel['device_ms']:.2f}% of device busy)")
    return _entry("ndt_ingest", SRC + "ndt_ingest.cu",
                  "none: the JAX package's map update (ndtpso_slam_tpu/models/ndt_map.py), XLA",
                  launches, worst_abs, ms, plain_ms, (bms, by), device_ms=kernel["device_ms"],
                  graph_ms=graph_ms, host_us=kernel["host_us"], reordered_rel_gap=worst)


def _evaluations(population, live_iterations):
    """Particle evaluations of whole solves: the gbest seed, the population,
    and the population again in each iteration a solve ran."""
    return sum(1 + population * (1 + int(i)) for i in live_iterations)


def _rollout_local_bound(sten, pts, population, live_iterations):
    pairs = _evaluations(population, live_iterations) * pts.shape[-2]  # pts [B, N, 8]
    return bound(_nbytes(sten, pts), fp32=ROLLOUT_LOCAL_FLOPS * pairs, sfu=pairs)


def _rollout_bound(sten, pts, population, live_iterations, score_dtype="f32"):
    """K2's bound: each evaluation scores the N points (15 features); bf16
    operands contract on the tensor cores."""
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
    # K1's turbo branch, and its Threefry branch at P=8192 (16 particles per
    # thread), which the one-block kernel's shared memory could not hold.
    for name, pop, kw in (("rollout_local_turbo", 50, dict(rng_mode="native")),
                          ("rollout_local", 8192, dict())):
        args = (keys, guesses, devs, lsten, lpts, C.PSOConfig(iterations=10, population=pop), mc)
        got = rl.pso_rollout_local(*args, **kw)
        torch.cuda.synchronize()
        ref = rl.pso_rollout_local_reference(*args, **kw)
        dpose, dcost = _compare(name, got, ref, COST_RTOL, COST_ATOL, POSE_ATOL)
        worst[name] = max(dpose, dcost)
        print(f"[phase 5a] {name} B={b} N=384 P={pop} I=10 (cluster "
              f"{rl.pso_rollout_local.LAST_CLUSTER}): max |dpose| {dpose:.3e} max |dcost| {dcost:.3e}")

    # The large-population routes (state in global scratch): K2 above its
    # shared-memory limit (5,189 at N=384), K1 above 16 particles per thread.
    for name, pop, run, plain in (
        ("rollout", 8192, ro.pso_rollout, ro.pso_rollout_reference),
        ("rollout", 16384, ro.pso_rollout, ro.pso_rollout_reference),
        ("rollout_local", 16384, rl.pso_rollout_local, rl.pso_rollout_local_reference),
    ):
        s, p = (lsten, lpts) if name == "rollout_local" else (sten, pts)
        args = (keys, guesses, devs, s, p, C.PSOConfig(iterations=10, population=pop), mc)
        got = run(*args)
        torch.cuda.synchronize()
        check(run.LAST_ROUTE == "global", f"{name} P={pop}: route {run.LAST_ROUTE}")
        ref = plain(*args, cluster=run.LAST_CLUSTER or 1)
        tol = (COST_RTOL, COST_ATOL, POSE_ATOL) if name == "rollout_local" else _TOLERANCES[name]
        dpose, dcost = _compare(f"{name} P={pop}", got, ref, *tol)
        key = f"{name}_global"
        worst[key] = max(worst.get(key, 0.0), dpose, dcost)
        print(f"[phase 5a] {name} global route B={b} N=384 P={pop} I=10 (cluster "
              f"{run.LAST_CLUSTER}): max |dpose| {dpose:.3e} max |dcost| {dcost:.3e}")

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
    from ndtpso_slam_tpu_torch.ops import ndt_ingest as ni
    from ndtpso_slam_tpu_torch.ops import probes
    from ndtpso_slam_tpu_torch.ops import reloc_step as rs
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
                rollout_bisect=rb.rollout_bisect, ndt_ingest=ni.ndt_ingest,
                reloc_step=rs.reloc_step)


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


def _trace(fn):
    """One call under torch.profiler: (the device operations it recorded,
    as key_averages' rows, wall ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA], wall


def _profile(fn, name=None):
    """One call under torch.profiler: (kernel launches, device busy ms, wall
    ms), of the kernels whose name holds `name` if one is given."""
    rows, wall = _trace(fn)
    kern = [e for e in rows if name is None or name in e.key]
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
        ms = _events_ms(kern, 20 if kname == "score" else 3)
        cluster = None if kname == "score" else ro.pso_rollout.LAST_CLUSTER
        plain_ms = _events_ms(plain, 1)
        print(f"[phase 5b] {kname} kernel vs plain ({shape}): max abs err {derr:.3e}; "
              f"kernel {ms:.4f} ms (cluster {cluster}), "
              f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        launches_main = counts["score" if kname == "score" else "rollout"]
        out[kname] = (launches_main, ms, plain_ms, derr, bnd, cluster)
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
        lib = rl.pso_rollout_local if name == "rollout_local_turbo" else ro.pso_rollout
        cluster = lib.LAST_CLUSTER
        plain_ms = _events_ms(plain, 1)
        held = _clusters_held(name, packed[4].shape[-2 if name == "rollout_local_turbo" else -1],
                              cfg.population)
        print(f"[phase 5c] {name} kernel vs plain (B={BATCH_SMALL} N=384 P={cfg.population} "
              f"I={cfg.iterations}): max abs err {derr:.3e}; kernel {ms:.4f} ms (cluster "
              f"{cluster}), plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); clusters "
              f"the card holds at once, by C: {held}")
        out[name] = (lc, ms, plain_ms, derr, bnd, cluster)
    return out


# Phase 5d: the large-population routes through solve_batch.  (mode, B,
# population): K2's global route at bench.py's batch width and twice its
# population; K1's (turbo, as phase 5c) at B=16 and 16,384 particles.
LARGE = (("rollout", BATCH, 8192), ("rollout_local_turbo", BATCH_SMALL, 16384))


def phase_batch_large(world):
    """5d: solve_batch in LARGE's modes: the accuracy gate, the one launch
    of the global route, and the kernel against its plain version on the
    call's own inputs, timed.  Returns {kernel name: (launches, ms, plain
    ms, max abs err, bound, cluster)}."""
    import dataclasses

    import torch

    from ndtpso_slam_tpu_torch.ops import _build
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.parallel import mesh

    out = {}
    for mode, b, pop in LARGE:
        sub = _first(world, b)
        sub["pso_cfg"] = cfg = dataclasses.replace(sub["pso_cfg"], population=pop)
        local = mode.startswith("rollout_local")
        lib = rl.pso_rollout_local if local else ro.pso_rollout
        _reset_counts()
        res = mesh.solve_batch(*sub["args"], sub["map_cfg"], cfg, mode)
        torch.cuda.synchronize()
        counts = _read_counts()
        want = _expected_launches(mode, cfg.iterations)
        check(all(counts[k] == want.get(k, 0) for k in counts),
              f"{mode} P={pop}: launches {counts}, expected {want}")
        check(lib.LAST_ROUTE == "global", f"{mode} P={pop}: route {lib.LAST_ROUTE}")
        err = np.abs(res.pose.cpu().numpy() - sub["true"])
        med_xy, med_th = float(np.median(err[:, :2])), float(np.median(err[:, 2]))
        check(med_xy < GATE_MEDIAN_XY_M and med_th < GATE_MEDIAN_TH_RAD,
              f"{mode} P={pop}: accuracy gate: median xy {med_xy:.4f} m, th {med_th:.5f} rad")
        packed = _packed(sub, local=local)
        kw = dict(rng_mode="native") if "turbo" in mode else {}
        kern = lambda: lib(*packed, **kw)
        plain_fn = rl.pso_rollout_local_reference if local else ro.pso_rollout_reference
        got = kern()
        torch.cuda.synchronize()
        cluster = lib.LAST_CLUSTER or 1
        plain = lambda: plain_fn(*packed, **kw, cluster=cluster)
        tol = _TOLERANCES["rollout_local_turbo" if local else "rollout"]
        ref = plain()
        if not local:
            ref = _take_k2_ties(f"{mode} P={pop}", packed, cluster, got, ref, tol)
        derr = max(_compare(f"{mode} P={pop}", got, ref, *tol))
        ms = _events_ms(kern, 3)
        plain_ms = _events_ms(plain, 1)
        iters = [cfg.iterations] * b
        bnd = (_rollout_local_bound(packed[3], packed[4], pop, iters) if local
               else _rollout_bound(packed[3], packed[4], pop, iters))
        scratch = b * cluster * _build.slice_floats(pop) * 4
        print(f"[phase 5d] solve_batch {mode} B={b} P={pop} I={cfg.iterations} N=384 (global "
              f"route, scratch {scratch / 2**20:.1f} MiB): median xy {med_xy:.4f} m, median th "
              f"{med_th:.5f} rad; launches {counts}; kernel vs plain max abs err {derr:.3e}; kernel "
              f"{ms:.4f} ms (cluster {cluster}), plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}, {100 * bnd[0] / ms:.1f}% of it)")
        name = "rollout_local_turbo_global" if local else "rollout_global"
        out[name] = (counts["rollout_local" if local else "rollout"], ms, plain_ms, derr, bnd,
                     cluster)
    return out


TIE_ROUNDS = 4  # ties 5d takes K2's side of before the check fails


def _parted(got, ref, tol):
    """Solves where (pose, cost) pairs part beyond (cost rtol, cost atol,
    pose atol)."""
    import torch

    (kp, kc), (rp, rc) = got, ref
    rtol, atol, patol = tol
    off = ~torch.isclose(kc, rc, rtol=rtol, atol=atol) | ((kp - rp).abs().amax(-1) > patol)
    return off.nonzero().flatten().tolist()


def _k2_plain_run(packed, cluster, steer, watch):
    """K2's plain version (ops/rollout.py:pso_rollout_reference) over the
    whole batch, in K2's cluster order, with each cost in ``steer``
    {(cost call, solve, particle): cost} replaced.  Returns (pose, cost) and,
    for solve ``watch``, the (poses [P, 3], binding pose [3], costs [P]) of
    every cost call."""
    import torch

    from ndtpso_slam_tpu_torch.models import cost as cost_mod
    from ndtpso_slam_tpu_torch.models.pso import pso_solve_batch
    from ndtpso_slam_tpu_torch.ops import rollout as ro

    keys, guesses, devs, sten, pts, cfg, mc = packed
    calls = []

    def cost_fn(poses, binds):
        c = ro.packed_frozen_cost(poses, binds, sten, pts, mc, cost_mod.DEFAULT_STENCIL_RADIUS,
                                  "f32", "exp", cluster)
        for (i, b, j), v in steer.items():
            if i == len(calls):
                c[b, j] = v
        calls.append((poses[watch].clone(), binds[watch].clone(), c[watch].clone()))
        return c

    res = pso_solve_batch(keys, guesses.to(torch.float32), devs.to(torch.float32), cost_fn, cfg)
    return (res.pose, res.cost), calls


def _k2_best_after(packed, cluster):
    """K2's global best (pose [B, 3], cost [B]) after k = 1 .. I
    iterations: the launch rerun with each budget (an iteration's draws do
    not depend on the budget)."""
    import dataclasses

    from ndtpso_slam_tpu_torch.ops import rollout as ro

    cfg = packed[5]
    return [ro.pso_rollout(*packed[:5], dataclasses.replace(cfg, iterations=k), packed[6],
                           cluster=cluster) for k in range(1, cfg.iterations + 1)]


def k2_tie(packed, cluster, s, steer, k2_best):
    """Where K2 and its plain version (``steer`` applied) part on solve s: the first iteration k whose global best
    differs, K2's pick a and the plain version's b there, the cost call and
    particle that evaluated each, their costs (K2's of a, the plain
    version's of both, and each in float64 under its call's binding pose),
    and whether it is a tie within the two sum orders' resolution."""
    import torch

    from ndtpso_slam_tpu_torch.models import cost as cost_mod
    from ndtpso_slam_tpu_torch.ops import rollout as ro

    cfg, mc = packed[5], packed[6]
    (rp, _), calls = _k2_plain_run(packed, cluster, steer, s)
    # The plain version's global best after k iterations is the binding pose
    # of iteration k's cost call (call k + 2), or its result after the last.
    plain_best = lambda k: calls[k + 2][1] if k < cfg.iterations else rp[s]
    k = next((k for k in range(1, cfg.iterations + 1)
              if not torch.equal(k2_best[k - 1][0][s], plain_best(k))), None)
    out = dict(solve=s, iteration=k, tie=False)
    if k is None:
        return out
    a, b = k2_best[k - 1][0][s], plain_best(k)
    out.update(a=a.tolist(), b=b.tolist(), k2_cost_a=float(k2_best[k - 1][1][s]))
    for name, pose in (("a", a), ("b", b)):
        hit = next(((i, int(j[0])) for i, (poses, _, _) in enumerate(calls[:k + 2])
                    for j in [(poses == pose).all(-1).nonzero().flatten()] if len(j)), None)
        if hit is None:
            return out
        i, j = hit
        out[f"call_{name}"], out[f"particle_{name}"] = i, j
        out[f"plain_cost_{name}"] = float(calls[i][2][j])
        f64 = lambda t: t[s:s + 1].to(torch.float64)
        out[f"f64_cost_{name}"] = float(ro.packed_frozen_cost(
            pose[None, None].to(torch.float64), calls[i][1][None].to(torch.float64),
            f64(packed[3]), f64(packed[4]), mc, cost_mod.DEFAULT_STENCIL_RADIUS)[0, 0])
    gap = out["plain_cost_a"] - out["plain_cost_b"]
    resolution = abs(out["k2_cost_a"] - out["plain_cost_a"])
    rtol, atol, _ = _TOLERANCES["rollout"]
    out.update(gap=gap, resolution=resolution,
               tie=0 <= gap <= resolution <= atol + rtol * abs(out["plain_cost_a"]))
    return out


def _take_k2_ties(name, packed, cluster, got, ref, tol):
    """5d's K2 check (module docstring, 5d): the plain version's result, run
    again taking K2's side of each tie on the solves that part from
    ``got``; a parting that is not such a tie fails."""
    import torch

    steer, k2_best, rounds = {}, None, 0
    while (off := _parted(got, ref, tol)) and rounds < TIE_ROUNDS:
        if k2_best is None:
            k2_best = _k2_best_after(packed, cluster)
            check(torch.equal(k2_best[-1][0], got[0]), f"{name}: K2 rerun differs from K2")
        for s in off:
            t = k2_tie(packed, cluster, s, steer, k2_best)
            check(t["tie"], f"{name}: solve {s} parts from its plain version, not at a tie: {t}")
            print(f"[phase 5d] {name}: solve {s} parts at iteration {t['iteration']}: K2 took "
                  f"particle {t['particle_a']} of cost call {t['call_a']} at {t['k2_cost_a']!r} "
                  f"(plain {t['plain_cost_a']!r}, float64 {t['f64_cost_a']!r}), the plain "
                  f"version kept particle {t['particle_b']} of call {t['call_b']} at "
                  f"{t['plain_cost_b']!r} (float64 {t['f64_cost_b']!r}): a tie, gap "
                  f"{t['gap']:.3e} <= resolution {t['resolution']:.3e}; the plain version "
                  f"takes K2's side")
            steer[(t["call_a"], s, t["particle_a"])] = t["k2_cost_a"]
        ref = _k2_plain_run(packed, cluster, steer, 0)[0]
        rounds += 1
    return ref


def _clusters_held(name, n_pts, population):
    """{C: the most clusters of C CTAs the card holds at once}
    (cudaOccupancyMaxActiveClusters) for K1 (``rollout_local*``) or K2 at
    this shape, for every C whose CTA fits the shared memory."""
    import torch

    from ndtpso_slam_tpu_torch.ops import _build
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    dev = torch.device("cuda")
    limit = _build.device_limits(torch.cuda.current_device())[0]
    local = name.startswith("rollout_local")
    glob = not local and ro.global_route(n_pts, population, limit)
    held = {}
    for c in _build.CLUSTER_SIZES:
        smem = (rl.smem_bytes(n_pts, population, c) if local
                else ro.smem_bytes(n_pts, population, c, glob))
        if smem + _build.STATIC_SMEM <= limit:
            held[c] = (rl.clusters_held(n_pts, population, c, 2, dev) if local
                       else ro.clusters_held(n_pts, population, c, glob, dev))
    return held


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
    """score_ops for a variant.  The outer route's semantics forbid the FMA
    (every product and every sum rounded), so each of its products and sums
    takes an issue slot of the FP32 pipes on its own: at the FMA-counted 67
    TFLOP/s each counts 2 flop-equivalents, twice score_ops' 2 per feature."""
    zpipe = {"bf16": "bf16", "tf32": "tf32"}.get(zroute, "fp32")
    rpipe = ("bf16" if zroute == "bf16" else "tf32") if reduce == "mma" else "fp32"
    ops = score_ops(pairs, features, zpipe, rpipe, masked)
    if zroute == "outer":
        ops["fp32"] += 2.0 * features * pairs
    return ops


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
        # One more launch of the run's shape, outside the counted run: the
        # cluster size chosen for it and the SMs its CTAs ran on.
        sms, ctas = sv.block_sms(phit, w, 1, name) if dev.type == "cuda" else (None, None)
        launch = sv.score_block.LAST or {"cluster": None}
        variants[name] = dict(ms=ms, ms_half_iterations=ms_half, plain_ms=plain_ms,
                              max_abs_err=err, bound_ms=bms, bound_by=by,
                              cluster=launch["cluster"], ctas=ctas, sms=sms)
        print(f"[phase 6b] {name} (B={b} N={w.shape[1]} P={p} I={rsv.I}): max |c - plain| "
              f"{err:.3e}, carry 0; kernel {ms:.4f} ms ({ms_half:.4f} ms at I={rsv.I // 2}), "
              f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it); "
              f"cluster C={launch['cluster']}, {ctas} CTAs on {sms} SMs")
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
    # A million update rows: more blocks than the card holds at once, so
    # the capped grid strides every phase.  Ids uniform over the fleet's rows
    # and the junk row.
    gid = torch.from_numpy(rs.randint(0, su.R + 1, E4_LARGE_M)).to(dev)
    gvals = torch.from_numpy(rs.randn(E4_LARGE_M, su.W).astype(np.float32)).to(dev)
    variants = {}
    for key, n_rows, idx, v, n_fields in (("w2", su.R, fid, vals, 1), ("w2_3fields", su.R, fid, vals, 3),
                                          ("w128", su.C, fid % su.C, vals128, 1),
                                          ("w2_large", su.R, gid, gvals, 1)):
        m = idx.shape[0]
        base = torch.randn((n_rows + 1, v.shape[1]), device=dev)
        vs = [v + k for k in range(n_fields)]
        got = rsc.row_scatter([base.clone() for _ in vs], idx, vs)
        want = rsc.row_scatter_reference([base.clone() for _ in vs], idx, vs)
        check(all(torch.equal(g, r) for g, r in zip(got, want)),
              f"scatter_unique_ab {key}: kernel differs from its plain version")
        del got, want
        ops = [base.clone() for _ in vs]
        plain_ms = _events_ms(lambda: rsc.row_scatter_reference(ops, idx, vs), 3)
        kernel = _time_split(lambda: rsc.row_scatter(ops, idx, vs), su.REPS, 1)
        # index_copy_ once per field, one kernel each: one call for one
        # field, the yardstick (library_ms) only there.
        library = _time_split(lambda: [op.index_copy_(0, idx, x) for op, x in zip(ops, vs)],
                              su.REPS, n_fields)
        unique = int(torch.unique(idx).numel())
        width = v.shape[1]
        # The M ids, then each target's winning row read once and written
        # once per field: a scatter-set moves no other row.
        bms, by = bound(8.0 * m + 2 * n_fields * 4.0 * width * unique)
        ms = kernel["ms"]
        variants[key] = dict(ms=ms, plain_ms=plain_ms,
                             library_ms=library["ms"] if n_fields == 1 else None,
                             max_abs_err=0.0, bound_ms=bms, bound_by=by, rows=n_rows + 1,
                             width=width, fields=n_fields, unique_rows=unique,
                             table_slots=rsc.table_slots(m), grid_blocks=rsc.grid_blocks(m),
                             device_ms=kernel["device_ms"], device_ops=kernel["device_ops"],
                             host_us=kernel["host_us"], index_copy=library)
        print(f"[phase 6d] row_scatter {key} ({n_rows + 1} rows x {width}, M={m}, {unique} "
              f"distinct targets; one launch, a table of {rsc.table_slots(m)} slots, "
              f"{rsc.grid_blocks(m)} blocks asked): kernel = plain bit for bit; plain "
              f"{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}, {100 * bms / ms:.2f}% of it)")
        for name, t in (("row_scatter", kernel), (f"index_copy_ x{n_fields}", library)):
            print(f"[phase 6d]   {name:15s}: {t['ms']:.4f} ms back to back (events), device busy "
                  f"{t['device_ms']:.4f} ms per call ({t['device_ops']:.1f} device operations "
                  f"recorded per call), host {t['host_us']:.1f} us per call until it returns")
        del base, ops
    print("[phase 6d] library calls (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in res.items() if isinstance(v, float)))
    entry = _study_entry("scatter_unique_ab", "row_scatter.cu",
                         "experiments/scatter_unique_ab.py:63", launches, variants, "w2",
                         library_ms=variants["w2"]["library_ms"])
    entry["library_calls_ms"] = {k: v for k, v in res.items() if isinstance(v, float)}
    return entry


# Phase 6d: update rows of the large variant, whose table asks for more
# blocks than the card holds at once.
E4_LARGE_M = 1_000_000


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
# is the wrapper's host time).  6f also times a CUDA graph of PROFILE_CALLS
# calls (_graph_ms: the median of GRAPH_SEGMENTS segments of GRAPH_REPLAYS
# replays), a reading no dropped record changes.
PROFILE_CALLS = 10
GRAPH_REPLAYS = 10
GRAPH_SEGMENTS = 7
# Profiled windows _window takes before it gives up on recording a
# kernel: late in a full run the profiler has recorded none of 10 launches
# (E5's sten4 at B=256).
PROFILE_TRIES = 3
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
    flush.sum()  # warm: the first reduction launch may load its module
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


def _graph_ms(fn, calls=PROFILE_CALLS):
    """ms per call of fn: one CUDA graph that holds `calls` calls back to
    back, replayed GRAPH_REPLAYS times to warm it and then in GRAPH_SEGMENTS
    segments of GRAPH_REPLAYS replays, each between two CUDA events; the
    median segment over its calls.  The device's time per call, launch gaps
    included and no host time, read in every run: no profiler record it
    could drop.  For measurement only; no path of the package captures a
    graph."""
    import torch

    fn()  # a first launch may load its module, which a capture must not
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    pairs = []
    for _ in range(GRAPH_SEGMENTS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs) / (GRAPH_REPLAYS * calls)


def _window(call, kernel=None, wrapper=None):
    """PROFILE_CALLS calls of `call` in one profiled window: the device
    operations it recorded, those whose name holds `kernel` (all, without
    one), their mean busy ms, and the launches `wrapper.LAUNCHES` counted in
    the window (None without a wrapper).  Late in a full run the profiler
    records only part of the launches (T1), never more, so a total over the
    calls would under-count; a window that recorded none of `kernel` is
    taken again, up to PROFILE_TRIES windows, and then fails."""
    for _ in range(PROFILE_TRIES):
        before = wrapper.LAUNCHES if wrapper is not None else 0
        rows = _trace(lambda: [call() for _ in range(PROFILE_CALLS)])[0]
        launches = wrapper.LAUNCHES - before if wrapper is not None else None
        own = [e for e in rows if kernel is None or kernel in e.key]
        ops, n_own = sum(e.count for e in rows), sum(e.count for e in own)
        if n_own > 0:
            break
    check(n_own > 0, f"the profiler recorded no launch of {kernel or 'any kernel'} in "
                     f"{PROFILE_TRIES} windows")
    busy_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                  for e in own)
    return dict(ops=ops, own=n_own, busy_ms=busy_us / 1e3 / max(n_own, 1), launches=launches)


def _time_split(fn, reps, kernels):
    """A call of `kernels` kernels and no other device operation timed three
    ways: CUDA events over reps calls back to back (ms), device busy per call
    (torch.profiler: `kernels` times the mean recorded kernel, as the
    profiler may miss some; with the operations it recorded per call), and
    the host time until the call returns (us)."""
    ops, busy, _ = _profile(lambda: [fn() for _ in range(PROFILE_CALLS)])
    return dict(ms=_events_ms(fn, reps), device_ms=busy / max(ops, 1) * kernels,
                device_ops=ops / PROFILE_CALLS, host_us=_host_us(fn))


def _sum_ok(got, want, magnitudes):
    return bool(((got - want).abs() <= SUM_RTOL * want.abs() + SUM_ATOL * magnitudes).all())


def _io_host_split(name, args, got, library):
    """6e's k_min / k_smem at C1's shape: the host time per call beside
    torch.sum's, and the device operations per call, which must all be the
    probe's kernel, one a call (both counted in one profiled window: the
    profiler may drop records late in a run, never add them); k_smem also with its keys as int32 words, whose
    result must be the same bits."""
    import torch

    from ndtpso_slam_tpu_torch.ops import probes

    call = lambda: probes.io_probe(name, *args)
    win = _window(call, "io_kernel_warp")  # both counts from one window, as it may drop records
    ops, own = win["ops"], win["own"]
    check(0 < ops == own <= PROFILE_CALLS,
          f"io_probe {name}: {ops} device operations in {PROFILE_CALLS} calls, {own} its kernel's")
    out = dict(host_us=_host_us(call), library_host_us=_host_us(library),
               device_ops=ops / PROFILE_CALLS)
    words = ""
    if name == "smem":
        pts, keys = args
        k32 = (keys - (keys >= 2**31).to(torch.int64) * 2**32).to(torch.int32)
        check(torch.equal(probes.io_probe(name, pts, k32), got),
              "io_probe smem: int32 key words give other bits than int64")
        words = "; int32 key words give the same bits"
    print(f"[phase 6e] {name} (B={args[0].shape[0]} N={args[0].shape[-1]}): host "
          f"{out['host_us']:.3f} us per call, torch.sum {out['library_host_us']:.3f} us; device "
          f"operations recorded per call {out['device_ops']:.2f}, every one io_kernel_warp"
          f"{words}")
    return out


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
            dev_ms = _window(lambda: probes.io_probe(name, *args), "io_kernel")["busy_ms"]
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
            if (b, n) == IO_WIDE and name in ("min", "smem"):
                variants[key].update(_io_host_split(name, args, got, library))
    ref = f"sten4_b{b_w}_n{n_w}"
    return _study_entry("io_probe", "probes.cu", "experiments/io_probe.py:53", launches, variants,
                        ref, library_ms=variants[ref]["library_ms"])


def _mosaic_ops(name, numel, n_dot):
    if name == "threefry":
        return dict(int32=float(THREEFRY_INT_OPS * numel))
    if name == "dotgen":  # the least the column totals need: the 8 row sums
        return dict(fp32=float(8 * n_dot + 2 * numel))  # over n, then 8 products and sums per q
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


def _mosaic_split(name, arg, n_dot, library):
    """6f's device readings of one probe on one tile, each from the kernel
    and, where there is one, its library call in the same way: the CUDA
    graph's time per call (_graph_ms), and in one profiled window the
    recorded operations per call and the mean recorded operation's busy
    time (per call for the kernel, one operation a call; per operation for
    the library call, `library_device_op_ms`: late in a run the profiler
    drops records, so a total over the calls would under-count).
    The kernel's window is checked against its wrapper's count: one launch
    per call, and at most one recorded operation per call, every one the
    probe's kernel."""
    from ndtpso_slam_tpu_torch.ops import probes

    call = lambda: probes.mosaic_probe(name, arg, n_dot)
    kernel = f"mosaic_kernel_{name}"
    win = _window(call, kernel, probes.mosaic_probe)
    check(win["launches"] == PROFILE_CALLS and 0 < win["ops"] == win["own"] <= PROFILE_CALLS,
          f"mosaic_probe {name}: {win['launches']} launches and {win['ops']} device operations in "
          f"{PROFILE_CALLS} calls, {win['own']} of them {kernel}")
    out = dict(graph_ms=_graph_ms(call), device_ms=win["busy_ms"],
               device_ops=win["ops"] / PROFILE_CALLS)
    if library is not None:
        lib = _window(library)
        out.update(library_graph_ms=_graph_ms(library), library_device_op_ms=lib["busy_ms"],
                   library_device_ops=lib["ops"] / PROFILE_CALLS)
    return out


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
            words = ""
            if name == "threefry":  # the counters as int32 and uint32 words: the same bits
                for w in ((xi - (xi >= 2**31).to(torch.int64) * 2**32).to(torch.int32),
                          xi.to(torch.uint32)):
                    check(torch.equal(probes.mosaic_probe(name, w, mp.N), got),
                          f"mosaic_probe threefry: {w.dtype} words give other bits than int64")
                words = "; int32 and uint32 words give the same bits"
            plain_ms = _events_ms(lambda: probes.mosaic_probe_reference(name, arg, mp.N), 3)
            library = _mosaic_library(name, x, mp.N)
            lib_ms = None
            if library is not None:
                check(_sum_ok(library(), want, probes.mosaic_magnitudes(name, x, mp.N)),
                      f"mosaic_probe {name}: the library call computes another function")
                lib_ms = _events_ms(library, mp.REPS)
            split = _mosaic_split(name, arg, mp.N, library)
            nbytes = 2.0 * 4 * x.numel()  # the u32 or f32 tile read, the f32 tile written
            bms, by = bound(nbytes, **_mosaic_ops(name, x.numel(), mp.N))
            key = f"{name}_{'ones' if seed is None else f'seed{seed}'}"
            variants[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                                 bound_ms=bms, bound_by=by, **split)
            lib = ""
            if library is not None:
                lib = (f"; library {lib_ms:.4f} ms, graph {1e3 * split['library_graph_ms']:.3f} us "
                       f"per call, device busy {1e3 * split['library_device_op_ms']:.3f} us per "
                       f"recorded operation, {split['library_device_ops']:.2f} operations per call")
            if name == "bcast_out":
                host = _host_us(lambda: probes.mosaic_probe(name, arg, mp.N))
                lib_host = _host_us(library)
                variants[key].update(host_us=host, library_host_us=lib_host)
                lib += f"; host {host:.3f} us per call, torch.sum {lib_host:.3f} us"
            print(f"[phase 6f] {key} ([8, {x.shape[1]}]): max |kernel - plain| {err:.3e}"
                  f"{' (bit-equal)' if name in MOSAIC_EXACT else ''}{words}; kernel {ms:.4f} ms "
                  f"back to back, graph {1e3 * split['graph_ms']:.3f} us per call, device busy "
                  f"{1e3 * split['device_ms']:.3f} us per recorded launch, "
                  f"{split['device_ops']:.2f} operations per call (each mosaic_kernel_{name}); "
                  f"plain {plain_ms:.4f} ms{lib}; bound {bms:.6f} ms ({by}, "
                  f"{100 * bms / split['graph_ms']:.2f}% of the graph time)")
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
    split = (ms[1], ms[2] - ms[1], ms[3] - ms[2], k2_ms - ms[3])
    print(f"[phase 6g] K2's time split (B={b_w} P={p_w} N={n_w} I={i_w}): draws+update / bind / "
          f"score / K2-only = {split[0]:.4f} / {split[1]:.4f} / {split[2]:.4f} / {split[3]:.4f} ms; "
          f"stage 3 {ms[3]:.4f} ms beside K2 (phase 5b) {k2_ms:.4f} ms")
    entry = _study_entry("rollout_bisect", "rollout_bisect.cu", "experiments/rollout_bisect.py:219",
                         launches, variants, "stage3_wide")
    entry["split_ms"] = dict(zip(("draws_update", "bind", "score", "k2_only"), split))
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


# Phase 7a: bench.py's multiswarm relocalization (bench.py:919-1009): K
# hypotheses at the true pose + U(+-1.5)(1, 1, 0.1), deviation (0.6, 0.6,
# 0.1), the island exchange every 5 iterations in multi_swarm_solve, and
# bench.py:1009's gate.
RELOC_K = 16
RELOC_TRUE = (0.8, -0.5, 0.06)
RELOC_DEV = (0.6, 0.6, 0.1)
RELOC_EXCHANGE = 5
RELOC_GATE_XY_M = 0.1
RELOC_GATE_TH_RAD = 0.02
# Phase 7c: bench.py's recovery workload at --full-scale (bench.py:626-770)
# and its gates; the step's latency against one 10 Hz period.
KIDNAP_OFFSET = (2.3, -1.8, 2.2)
KIDNAP_KEY = (11, 13)
KIDNAP_SWEEP = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (21, 9), (17, 18))
KIDNAP_GATE = (0.3, 0.3, 0.1)
PERIOD_MS = 100.0
KIDNAP_REPS = 5


def reloc_world(dev, iterations=50, population=4096):
    """bench.py's multiswarm workload with its seeds, built with the port's
    modules: a 64 m map of 1 m cells (4 slots) from three jittered scans of
    make_world(seed=1, size=50, n_boxes=8) at the origin; the query scan
    from RELOC_TRUE (360 beams padded to 384); RELOC_K keys and
    hypotheses."""
    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.models import scan as scan_mod

    map_cfg = C.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=4)
    scan_cfg = C.ScanConfig(max_beams=384)
    beams, amin, inc, rmax = 360, -np.pi, 2 * np.pi / 360, 30.0
    rs = np.random.RandomState(0)
    segs = synthetic.make_world(seed=1, size=50.0, n_boxes=8)
    load = lambda pose: scan_mod.load_laser(
        synthetic.raycast(segs, np.asarray(pose, np.float64), beams, amin, inc, rmax)
        .astype(np.float32), amin, inc, rmax, scan_cfg, map_cfg, device=dev)
    ref = load(np.zeros(3))
    state = ndt_map.init_map(map_cfg, device=dev)
    for _ in range(3):
        jit_pts = ref.points.cpu().numpy() + rs.normal(0, 0.03, (384, 2))
        ndt_map.add_points(state, map_cfg, torch.from_numpy(jit_pts.astype(np.float32)).to(dev),
                           ref.valid)
        ndt_map.build(state, map_cfg)
    true = np.float32(RELOC_TRUE)
    q = load(true)
    keys = rs.randint(0, 2**31, (RELOC_K, 2)).astype(np.uint32).astype(np.int64)
    hypo = true + rs.uniform(-1.5, 1.5, (RELOC_K, 3)).astype(np.float32) * np.float32([1, 1, 0.1])
    return dict(map_cfg=map_cfg, pso_cfg=C.PSOConfig(iterations=iterations, population=population),
                snap=ndt_map.snapshot(state, map_cfg), points=q.points, valid=q.valid, true=true,
                keys=torch.from_numpy(keys).to(dev), hypo=torch.from_numpy(hypo).to(dev))


def _reloc_gate(name, pose, true):
    err = np.abs(pose.cpu().numpy().astype(np.float64) - true)
    check(np.isfinite(err).all() and err[:2].max() < RELOC_GATE_XY_M and err[2] < RELOC_GATE_TH_RAD,
          f"{name}: relocalization gate: err {err.round(4)}")
    return err


def _reloc_rate(run):
    """Relocalizations/s under bench.py's protocol: one warm call, then REPS
    enqueued and one synchronize."""
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [run() for _ in range(REPS)]
    torch.cuda.synchronize()
    del outs
    return REPS / (time.perf_counter() - t0)


def _reloc_packed(w, local=False):
    """The kernel inputs of multi_swarm_rollout's B = K call: the stencil at
    each hypothesis against the one shared snapshot."""
    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    k = w["hypo"].shape[0]
    points, valid = w["points"].expand(k, -1, -1), w["valid"].expand(k, -1)
    nbr = cost.bind_neighborhood(w["hypo"], w["snap"], points, valid, w["map_cfg"])
    pack = rl.pack_rollout_local_inputs if local else ro.pack_rollout_inputs
    devs = w["hypo"].new_tensor(RELOC_DEV).expand(k, 3)
    return (w["keys"], w["hypo"], devs, *pack(nbr, points), w["pso_cfg"], w["map_cfg"])


def phase_reloc_c2(w):
    """7a: multi_swarm_rollout (K2 at B = K, f32 and bf16) and
    multi_swarm_solve (the matmul binder through K3, exchange every 5) at
    bench.py's shape: the gate, relocalizations/s, the launches, and K2
    against its plain version on the call's own inputs, timed, with its
    bound, its C and its waves.  Returns K2's kernels-line entry."""
    import torch

    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import _build
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.parallel import multi_swarm as ms

    cfg, mc = w["pso_cfg"], w["map_cfg"]
    k, dev = RELOC_K, w["hypo"].device
    shape = f"K={k} P={cfg.population} I={cfg.iterations} N=384"
    out = {}
    for dtype in ("f32", "bf16"):
        run = lambda: ms.multi_swarm_rollout(w["keys"], w["hypo"], RELOC_DEV, w["snap"],
                                             w["points"], w["valid"], cfg, mc, score_dtype=dtype)
        torch.cuda.synchronize()
        _reset_counts()
        res = run()
        torch.cuda.synchronize()
        counts = _read_counts()
        check(counts == {n: int(n == "rollout") for n in counts},
              f"multi_swarm_rollout {dtype}: launches {counts}, expected one rollout")
        err = _reloc_gate(f"multi_swarm_rollout {dtype}", res.pose, w["true"])
        rate = _reloc_rate(run)
        packed = _reloc_packed(w)
        kw = dict(score_dtype=dtype)
        kern = lambda: ro.pso_rollout(*packed, **kw)
        got = kern()
        torch.cuda.synchronize()
        cluster = ro.pso_rollout.LAST_CLUSTER
        plain = lambda: ro.pso_rollout_reference(*packed, **kw, cluster=cluster)
        derr = max(_compare(f"multi_swarm_rollout {dtype}", got, plain(),
                            *_TOLERANCES["rollout" if dtype == "f32" else "rollout_bf16"]))
        ms_k = _events_ms(kern, 5)
        plain_ms = _events_ms(plain, 1)
        bnd = _rollout_bound(packed[3], packed[4], cfg.population, [cfg.iterations] * k, dtype)
        held = _clusters_held("rollout", packed[4].shape[-1], cfg.population)
        waves = _build.waves(k, held[cluster])
        print(f"[phase 7a] multi_swarm_rollout {dtype} ({shape}, one K2 launch): err "
              f"{err.round(4)} (gate {RELOC_GATE_XY_M} m / {RELOC_GATE_TH_RAD} rad); {rate:.1f} "
              f"relocalizations/s; launches {counts}; K2 vs plain max abs err {derr:.3e}; kernel "
              f"{ms_k:.4f} ms (cluster {cluster}, {waves} wave(s); clusters held by C: {held}), "
              f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
              f"{100 * bnd[0] / ms_k:.1f}% of it)")
        out[dtype] = dict(launches=counts["rollout"], err=derr, ms=ms_k, plain_ms=plain_ms, bnd=bnd,
                          cluster=cluster, waves=waves, relocalizations_s=rate)

    tbl = cost.snapshot_table(w["snap"])
    cost_fn = lambda poses, binds: cost.bound_cost_fused(
        poses, cost.bind_points_matmul(binds, tbl, w["points"], w["valid"], mc))
    run = lambda: ms.multi_swarm_solve(w["keys"], w["hypo"], RELOC_DEV, cost_fn, cfg,
                                       exchange_every=RELOC_EXCHANGE)
    torch.cuda.synchronize()
    _reset_counts()
    res = run()
    torch.cuda.synchronize()
    counts = _read_counts()
    want = {n: (cfg.iterations + 2 if n == "score" else 0) for n in counts}
    check(counts == want, f"multi_swarm_solve: launches {counts}, expected {want}")
    err = _reloc_gate("multi_swarm_solve", res.pose, w["true"])
    rate = _reloc_rate(run)
    print(f"[phase 7a] multi_swarm_solve, matmul binder, K3, exchange every {RELOC_EXCHANGE} "
          f"({shape}): err {err.round(4)}; {rate:.1f} relocalizations/s; launches {counts}")
    f32 = out["f32"]
    return _entry("rollout_multiswarm", SRC + "rollout.cu", "ndtpso_slam_tpu/ops/pallas_rollout.py:111",
                  f32["launches"], max(o["err"] for o in out.values()), f32["ms"], f32["plain_ms"],
                  f32["bnd"], cluster=f32["cluster"], waves=f32["waves"],
                  relocalizations_s=f32["relocalizations_s"],
                  bf16={k: v for k, v in out["bf16"].items() if k != "bnd"}
                  | dict(bound_ms=out["bf16"]["bnd"][0], bound_by=out["bf16"]["bnd"][1]))


def _host_us(fn, reps=200):
    """The host time of one call until it returns (µs), the card not awaited
    (the wrapper's own work)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def phase_chooser(w, main_inputs, step_p50):
    """7b: the cluster chooser at B = 16 against C = 8 on one card: K2 f32
    and bf16 and K1 turbo on 7a's inputs, chosen C and C = 8 alternating
    (A B B A); K1's B = 1 launch on phase 4's inputs, its host time through
    the cached choice and with C = 8 forced."""
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    packed, lpacked = _reloc_packed(w), _reloc_packed(w, local=True)
    rows = {}
    for name, fn, args, kw in (("K2 f32", ro.pso_rollout, packed, {}),
                               ("K2 bf16", ro.pso_rollout, packed, dict(score_dtype="bf16")),
                               ("K1 turbo", rl.pso_rollout_local, lpacked, dict(rng_mode="native"))):
        fn(*args, **kw)
        chosen = fn.LAST_CLUSTER
        times = {chosen: [], 8: []}
        for c in (chosen, 8, 8, chosen):
            times[c].append(_events_ms(lambda: fn(*args, **kw, cluster=c), 3))
        rows[name] = (chosen, times)
        print(f"[phase 7b] {name} B={RELOC_K} P={w['pso_cfg'].population} I="
              f"{w['pso_cfg'].iterations}: chosen C={chosen} "
              f"{', '.join(f'{t:.4f}' for t in times[chosen])} ms; C=8 "
              f"{', '.join(f'{t:.4f}' for t in times[8])} ms "
              f"({np.mean(times[8]) / np.mean(times[chosen]):.3f}x)")
    run = lambda **kw: rl.pso_rollout_local(*main_inputs, **kw)
    cached, forced = _host_us(run), _host_us(lambda: run(cluster=8))
    print(f"[phase 7b] K1 B=1 (phase 4's next solve): host time per call {cached:.1f} us through "
          f"the cached choice (C={rl.pso_rollout_local.LAST_CLUSTER}), {forced:.1f} us with C=8 "
          f"forced; phase 4 step p50 {step_p50:.3f} ms")
    return rows


def reloc_launch_world(dev, window_slots=100):
    """bench.py's recovery workload at --full-scale, built with the port:
    the scan.launch frame (300 m, 0.5 m cells, window_slots slots), P=50,
    I=30, 384 padded beams, cost_mode rollout_local, the default
    RecoveryConfig; a map built at ground truth from the first 30 scans of
    make_log(seed=3, n_scans=31, world_size=50), the state at poses[29];
    the healthy scan from poses[30] and the kidnapped one from poses[30] +
    KIDNAP_OFFSET.  As bench.py does, the scans and the map are made on the
    host (whose scatter-adds run in a fixed order, where the card's
    atomics would vary the map's last bits from run to run) and then moved
    to ``dev``.  Returns (cfg, state, healthy, kidnapped, kidnap pose)."""
    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.models import ndt_map, slam
    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.ops.geometry import cell_index, transform_points
    from ndtpso_slam_tpu_torch.utils.state import slam_state_from_numpy, slam_state_to_numpy

    cfg = C.SlamConfig(pso=C.PSOConfig(iterations=30, population=50),
                       map=C.MapConfig(size_m=300.0, cell_side_m=0.5, window_slots=window_slots),
                       scan=C.ScanConfig(max_beams=384), cost_mode="rollout_local",
                       recovery=C.RecoveryConfig(enabled=True))
    mc, host = cfg.map, torch.device("cpu")
    lg = synthetic.make_log(seed=3, n_scans=31, n_beams=360, world_size=50.0)
    load = lambda r: scan_mod.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max,
                                         cfg.scan, mc, device=host)
    loaded = [load(r) for r in lg.ranges]
    st = slam.init_slam(cfg, tuple(lg.poses[0]), host)
    prev_ids = st.prev_ids
    for s, pose in zip(loaded[:30], lg.poses[:30]):
        wpts = transform_points(s.points, torch.tensor(pose, dtype=torch.float32))
        idx, inb = cell_index(wpts, size_m=mc.size_m, cell_side_m=mc.cell_side_m,
                              cells_per_side=mc.cells_per_side)
        ids = torch.where(s.valid & inb, idx, mc.num_cells).to(torch.int32)
        ndt_map.add_points(st.map, mc, wpts, s.valid)
        ndt_map.build_touched(st.map, mc, torch.cat([ids, prev_ids]))
        prev_ids = ids
    pose = torch.tensor(lg.poses[29], dtype=torch.float32)
    st.prev_ids, st.pose, st.step = prev_ids, pose, 30
    st.align = slam.AlignState(prev_pose=pose.clone(), iter=30, pose_diff=torch.tensor(
        lg.poses[29] - lg.poses[28], dtype=torch.float32))
    kid_pose = lg.poses[30] + np.float64(KIDNAP_OFFSET)
    kid = synthetic.raycast(synthetic.make_world(seed=3, size=50.0), kid_pose, 360, lg.angle_min,
                            lg.angle_increment, lg.range_max)
    to = lambda s: scan_mod.Scan(points=s.points.to(dev), valid=s.valid.to(dev))
    st = slam_state_from_numpy(slam_state_to_numpy(st), cfg, device=dev)
    return cfg, st, to(loaded[30]), to(load(kid.astype(np.float32))), kid_pose


def _kidnap_err(pose, kid_pose):
    """|pose - truth| with the angle wrapped to [0, π]."""
    err = np.abs(pose.cpu().numpy().astype(np.float64) - kid_pose)
    err[2] = abs((err[2] + np.pi) % (2 * np.pi) - np.pi)
    return err


def _fresh(st):
    """A copy of a SLAM state whose map the next step may update in place."""
    import copy
    import dataclasses

    from ndtpso_slam_tpu_torch.models import ndt_map

    out = copy.copy(st)
    out.map = ndt_map.NdtMapState(**{f.name: getattr(st.map, f.name).clone()
                                     for f in dataclasses.fields(st.map)})
    return out


def _step_ms(st, scan, cfg, reps=KIDNAP_REPS):
    """slam_step on fresh copies of st: (the last result, the median ms of
    reps steps, each from its call to the card's end)."""
    import torch

    from ndtpso_slam_tpu_torch.models import slam

    times, res = [], None
    for _ in range(reps):
        s = _fresh(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = slam.slam_step(s, scan, KIDNAP_KEY, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return res, float(np.median(times))


def phase_recovery(dev, window_slots=100):
    """7c: the kidnapped step at scan.launch scale: recoveries == 1 and
    bench.py's error gate at bench.py's key, the launches (K1 once in the
    align, K3 in each of stages 2-3's evaluations), the step at the
    KIDNAP_SWEEP keys (reported), the event latency against one 10 Hz
    period, one event profiled, the peak device memory, and the healthy
    step with recovery on against off (poses bit-equal); then K3 on the
    operands of the event's last scoring call against its plain version
    and float64, timed, and every reloc_step launch of the event held to
    the PyTorch binder (_check_reloc_launches) and each fold to
    pso_solve_batch fed the same K3 costs (_check_reloc_folds), a solve
    through it bit for bit with the plain solve, timed per launch, per
    event and per solve beside the plain solve.  Returns the kernels-line
    entries of K3 and reloc_step."""
    import dataclasses
    from unittest import mock

    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.models import pso, slam
    from ndtpso_slam_tpu_torch.models.scan import Scan
    from ndtpso_slam_tpu_torch.ops import reloc_step as rs
    from ndtpso_slam_tpu_torch.ops import score as sc

    cfg, st, healthy, kidnapped, kid_pose = reloc_launch_world(dev, window_slots)
    rc = cfg.recovery
    s = _fresh(st)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    new, pose, _ = slam.slam_step(s, kidnapped, KIDNAP_KEY, cfg)
    torch.cuda.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    evals = 2 * (rc.pso.iterations + 2)
    want = {n: {"rollout_local": 1, "score": evals, "reloc_step": evals, "ndt_ingest": 1}.get(n, 0)
            for n in counts}
    check(counts == want, f"kidnapped step: launches {counts}, expected {want}")
    err = _kidnap_err(pose, kid_pose)
    check(new.recoveries == 1 and all(e < g for e, g in zip(err, KIDNAP_GATE)),
          f"kidnapped step: recoveries {new.recoveries}, err {err.round(4)}")
    # The same step at other keys: reported, not gated (ROADMAP R5).
    sweep = []
    for key in KIDNAP_SWEEP:
        new_k, pose_k, _ = slam.slam_step(_fresh(st), kidnapped, key, cfg)
        err_k = _kidnap_err(pose_k, kid_pose)
        sweep.append((key, new_k.recoveries, all(e < g for e, g in zip(err_k, KIDNAP_GATE)),
                      float(err_k[:2].max())))
    _, event_ms = _step_ms(st, kidnapped, cfg)
    s = _fresh(st)
    n_kern, busy_ms, wall_ms = _profile(lambda: slam.slam_step(s, kidnapped, KIDNAP_KEY, cfg))
    off_cfg = dataclasses.replace(cfg, recovery=C.RecoveryConfig())
    (h_on, p_on, _), on_ms = _step_ms(st, healthy, cfg)
    (h_off, p_off, _), off_ms = _step_ms(st, healthy, off_cfg)
    check(h_on.recoveries == 0 and torch.equal(p_on, p_off),
          f"healthy step: recoveries {h_on.recoveries}, recovery on/off poses {p_on} {p_off}")
    print(f"[phase 7c] kidnapped step (300 m / 0.5 m / {window_slots} slots, grid {rc.grid}, "
          f"K={rc.k_hypotheses}, window {rc.patch_cells}, rollout_local align): recoveries 1, err "
          f"{err.round(4)} (gate {KIDNAP_GATE}); launches {counts}; event latency {event_ms:.3f} ms "
          f"(median of {KIDNAP_REPS}; {'within' if event_ms < PERIOD_MS else 'OVER'} the "
          f"{PERIOD_MS:.0f} ms period); one event under torch.profiler: {n_kern} device kernels, "
          f"busy {busy_ms:.3f} of {wall_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%); "
          f"peak device memory {peak / 2**20:.1f} MiB above the "
          f"state; healthy step {on_ms:.3f} ms with recovery on, {off_ms:.3f} ms off "
          f"({100 * (on_ms - off_ms) / off_ms:+.1f}%), poses bit-equal")
    print(f"[phase 7c] the kidnapped step at {len(sweep)} other keys: "
          f"{sum(ok for *_, ok, _ in sweep)} within the gate, all recovered: "
          f"{all(r == 1 for _, r, _, _ in sweep)}; (key, recoveries, within, max xy err m): "
          f"{[(k, r, ok, round(e, 4)) for k, r, ok, e in sweep]}")

    # K3 on the operands of the event's last scoring call; every
    # reloc_step launch's operands and state, and the costs it folded.
    seen, costs, launches, real, real_launch = [], [], [], rs.fused_bound_scores, rs._launch

    def recording(*ops):
        seen.append(tuple(t.clone() for t in ops))
        out = real(*ops)
        costs.append(out.clone())
        return out

    def recording_launch(sw, phase, *args, **kwargs):
        real_launch(sw, phase, *args, **kwargs)
        if phase != rs.FINAL:
            launches.append((sw, phase) + tuple(t.clone() for t in (sw.state, sw.phit_seed,
                                                                    sw.phit, sw.w, sw.mask)))

    with mock.patch.object(rs, "fused_bound_scores", recording), \
            mock.patch.object(rs, "_launch", recording_launch):
        slam.slam_step(_fresh(st), kidnapped, KIDNAP_KEY, cfg)
    # Every reloc_step launch writes K3's operands but each solve's final.
    check(len(seen) == evals and len(launches) == evals - 2,
          f"recorded {len(seen)} K3 calls and {len(launches)} reloc_step launches with operands, "
          f"expected {evals} and {evals - 2}")
    ops = seen[-1]
    b, f, p = ops[0].shape
    derr = _check_score(ops, "7c", f"B={b} N={ops[1].shape[1]} P={p}, the event's last call")
    ms_k = _events_ms(lambda: sc.fused_bound_scores(*ops), 50)
    plain_ms = _events_ms(lambda: sc.fused_bound_scores_reference(*ops), 20)
    bnd = _score_bound(ops)
    print(f"[phase 7c] K3 in recovery: kernel {ms_k:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bnd[0]:.6f} ms ({bnd[1]}, {100 * bnd[0] / ms_k:.1f}% of it); {counts['score']} "
          f"launches per event")
    k3 = _entry("score_recovery", SRC + "score.cu", "ndtpso_slam_tpu/ops/pallas_score.py:41",
                counts["score"], derr, ms_k, plain_ms, bnd, event_ms=event_ms,
                peak_mib=peak / 2**20)

    # reloc_step: each launch against the PyTorch binder and features, each
    # solve's state against pso_solve_batch fed the same K3 costs; a solve
    # through it against the plain pso_solve_batch solve (K3 in both), bit
    # for bit; its device time per launch and per event, and the two solves
    # timed, per evaluation.
    dw, dphi, w_equal = _check_reloc_launches(launches)
    n_folds = _check_reloc_folds(launches, costs)
    sw0 = launches[0][0]
    args = (sw0.keys, sw0.guesses, sw0.deviation, sw0.tbl, sw0.anchor, sw0.ps, sw0.points,
            sw0.valid, sw0.map_cfg, sw0.pso_cfg)
    devs = torch.tensor(sw0.deviation, dtype=torch.float32, device=dev).expand(len(sw0.guesses), 3)
    plain_cost = slam._refine_cost(sw0.tbl, sw0.anchor, sw0.ps, Scan(sw0.points, sw0.valid), cfg)
    got = rs.refine_solve(*args)
    want = pso.pso_solve_batch(sw0.keys, sw0.guesses, devs, plain_cost, rc.pso)
    check(torch.equal(got[0], want.pose) and torch.equal(got[1], want.cost),
          f"reloc_step: the refine's first solve {got[0].tolist()} {got[1].tolist()}, "
          f"pso_solve_batch on the PyTorch binder {want.pose.tolist()} {want.cost.tolist()}")
    s = _fresh(st)
    n_rs, rs_busy_ms, _ = _profile(lambda: slam.slam_step(s, kidnapped, KIDNAP_KEY, cfg),
                                   "reloc_step_kernel")
    sw = rs.reloc_init(*args)
    seed_cost = sc.fused_bound_scores(sw.phit_seed, sw.w, sw.mask)
    last_cost = sc.fused_bound_scores(sw.phit, sw.w, sw.mask)
    rs.reloc_step(sw, 0, last_cost, seed_cost)
    ms_rs = _events_ms(lambda: rs.reloc_step(sw, 1, last_cost), 50)
    solve_ms = _events_ms(lambda: rs.refine_solve(*args), 10)
    plain_solve_ms = _events_ms(
        lambda: pso.pso_solve_batch(sw0.keys, sw0.guesses, devs, plain_cost, rc.pso), 5)
    per_eval = rc.pso.iterations + 2
    plain_rs = plain_solve_ms / per_eval - ms_k  # the plain glue of one evaluation
    b, p, n = len(sw.guesses), rc.pso.population, sw.points.shape[0]
    bnd_rs = bound(_reloc_step_bytes(b, p, n), int32=b * p * 3 * THREEFRY_INT_OPS)
    per_launch = rs_busy_ms / max(n_rs, 1)
    print(f"[phase 7c] reloc_step (B={b} P={p} N={n}, window {sw.ps}): each of the event's "
          f"{len(launches)} launches' masks bit for bit with the PyTorch binder's, w within "
          f"{dw:.3e} of its largest coefficient ({100 * w_equal:.2f}% bit-equal), features within "
          f"{dphi:.3e}; the state after each of its {n_folds} folds and both solves' results bit "
          f"for bit with pso_solve_batch fed the same K3 costs; the first solve bit for bit with "
          f"pso_solve_batch on the PyTorch binder; a step launch {ms_rs:.4f} ms (CUDA events), device busy "
          f"{per_launch:.4f} ms per recorded launch ({n_rs} of {counts['reloc_step']} recorded), "
          f"{per_launch * counts['reloc_step']:.4f} ms per event; bound {bnd_rs[0]:.6f} ms "
          f"({bnd_rs[1]}); a solve of {per_eval} "
          f"evaluations {solve_ms:.3f} ms through it, {plain_solve_ms:.3f} ms plain "
          f"(pso_solve_batch, K3 in both): the plain glue {plain_rs:.4f} ms an evaluation")
    reloc = _entry("reloc_step", SRC + "reloc_step.cu", "none: the JAX refine's glue, left to XLA",
                   counts["reloc_step"], dw, ms_rs, plain_rs, bnd_rs, device_ms=per_launch,
                   event_device_ms=per_launch * counts["reloc_step"],
                   solve_ms=solve_ms, plain_solve_ms=plain_solve_ms)
    return [k3, reloc]


# reloc_step's operands against the PyTorch binder: w within this share of
# each point's largest coefficient (the cancelling terms of BᵀΛB), the
# features within this absolute error.
RELOC_W_RTOL = 1e-5
RELOC_PHI_ATOL = 1e-6


def _reloc_step_bytes(b, p, n):
    """The bytes one reloc_step launch must move: the state read and
    written, K3's costs, the N table rows each swarm binds, the points, and
    the features, w and mask written."""
    return 4.0 * (2 * b * (10 * p + 4) + b * p + 6 * b * n + 15 * b * p + 15 * b * n + b * n) \
        + 9.0 * n


def _check_reloc_folds(launches, costs):
    """Each solve of the event's refine (the recorded launches of one
    Swarms: its init, then each step) against pso_solve_batch fed the K3
    costs that solve folded (``costs``, I + 2 a solve, in launch order): the
    poses it scores and the global best it binds at each evaluation, and
    its result, bit for bit.  This holds the folds (strict <, first minimal
    index, the NaN rule), the draws and the update to the plain solver, at
    the kernel's own costs.  Returns the number of folds checked."""
    import torch

    from ndtpso_slam_tpu_torch.models import pso

    solves = []
    for rec in launches:
        if not any(rec[0] is sw for sw in solves):
            solves.append(rec[0])
    folds = 0
    for j, sw in enumerate(solves):
        recs = [rec for rec in launches if rec[0] is sw]
        b, p, it = len(sw.guesses), sw.pso_cfg.population, sw.pso_cfg.iterations
        mine = costs[j * (it + 2):(j + 1) * (it + 2)]
        check(len(recs) == it + 1 and len(mine) == it + 2,
              f"solve {j}: {len(recs)} launches and {len(mine)} K3 costs, expected {it + 1} and "
              f"{it + 2}")
        seen = []

        def cost_fn(poses, binds):
            seen.append((poses.clone(), binds.clone()))
            return mine[len(seen) - 1]

        devs = torch.tensor(sw.deviation, dtype=torch.float32,
                            device=sw.guesses.device).expand(b, 3)
        res = pso.pso_solve_batch(sw.keys, sw.guesses, devs, cost_fn, sw.pso_cfg)
        check(len(seen) == it + 2, f"solve {j}: pso_solve_batch made {len(seen)} evaluations")
        unpack = lambda state: (state[:, :3 * p].reshape(b, 3, p).transpose(1, 2),
                                state[:, 10 * p:10 * p + 3])
        pos0, gbest0 = unpack(recs[0][2])
        check(torch.equal(seen[0][0][:, 0], gbest0) and torch.equal(seen[1][0], pos0),
              f"solve {j}: the init's seeds or population differ from pso_solve_batch's")
        for i in range(it):
            pos, gbest = unpack(recs[i + 1][2])
            check(torch.equal(seen[i + 2][0], pos) and torch.equal(seen[i + 2][1], gbest),
                  f"solve {j}: the state after fold {i} differs from pso_solve_batch's")
        check(torch.equal(sw.pose, res.pose) and torch.equal(sw.cost, res.cost),
              f"solve {j}: result {sw.pose.tolist()} {sw.cost.tolist()}, pso_solve_batch's "
              f"{res.pose.tolist()} {res.cost.tolist()}")
        folds += it + 1
    check(len(solves) == 2, f"{len(solves)} solves recorded, expected the refine's 2")
    return folds


def _check_reloc_launches(launches):
    """Each recorded reloc_step launch (the Swarms, its phase, then clones
    of its state, features, w and mask) against the PyTorch binder and
    pose_features_t at the bind pose the launch used (the guesses at the
    init, else the global best after the fold): the mask bit for bit, w
    within RELOC_W_RTOL of each point's largest coefficient, the features
    within RELOC_PHI_ATOL.  Returns (the largest w error, the largest
    feature error, the share of w bit-equal)."""
    import torch

    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import reloc_step as rs

    dw = dphi = 0.0
    equal = total = 0
    for sw, phase, state, phit_seed, phit, w, mask in launches:
        b, p = state.shape[0], sw.pso_cfg.population
        pos = state[:, :3 * p].reshape(b, 3, p).transpose(1, 2)
        gbest = state[:, 10 * p:10 * p + 3]
        bind = sw.guesses if phase == rs.INIT else gbest
        if sw.ps:
            origin = cost.window_origin(sw.anchor, sw.ps, sw.map_cfg)
            ref = cost.bind_points_matmul_window(
                bind, cost.table_window(sw.tbl, origin, sw.ps, sw.map_cfg), origin, sw.ps,
                sw.points, sw.valid, sw.map_cfg)
        else:
            ref = cost.bind_points_matmul(bind, sw.tbl, sw.points, sw.valid, sw.map_cfg)
        check(torch.equal(mask, ref.mask), "reloc_step: a launch's mask differs from the binder's")
        scale = ref.w.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
        dw = max(dw, ((w - ref.w).abs() / scale).max().item())
        equal += int((w == ref.w).sum())
        total += w.numel()
        dphi = max(dphi, (phit - cost.pose_features_t(pos, bind)).abs().max().item())
        if phase == rs.INIT:
            seed = cost.pose_features_t(gbest[:, None], bind)
            dphi = max(dphi, (phit_seed - seed).abs().max().item())
    check(dw <= RELOC_W_RTOL and dphi <= RELOC_PHI_ATOL,
          f"reloc_step: w {dw:.3e} (limit {RELOC_W_RTOL}), features {dphi:.3e} (limit "
          f"{RELOC_PHI_ATOL}) from the PyTorch binder's")
    return dw, dphi, equal / max(total, 1)


# ---------------------------------------------------------------- phase 8

HERE = os.path.dirname(os.path.abspath(__file__))
REALISTIC = os.path.join(HERE, "tests", "data", "realistic.bag")
REALISTIC_GT = os.path.join(HERE, "tests", "data", "realistic_gt.npy")
# tests/test_realdata.py:98-126's gate: max error against the ground truth,
# and an end closer to it than the drifting odometry.
REAL_GATE_MAX_M = 0.3
# tests/test_node.py's GLIR plausibility gate (max error).
GLIR_GATE_MAX_M = 1.0
# 8b: the first sparse ring tried, doubled until no cell overflows.
RING_ROWS_START = 16384
CHECKPOINT_AT = 25


def _real_cfg(lg, **over):
    """tests/test_realdata.py's configuration on the bag, from the odometry's
    first pose: a 48 m frame of 1 m cells, 8 slots, P=50, I=30."""
    from ndtpso_slam_tpu_torch.node import NodeConfig

    return NodeConfig(frame_size_m=48.0, cell_side_m=1.0, window_slots=8, pso_iterations=30,
                      pso_population=50, init_pose=tuple(float(v) for v in lg.odoms[0]), **over)


def _errors(node, truth):
    poses = np.stack(node.poses)
    check(np.isfinite(poses).all() and poses.shape == (len(truth), 3),
          f"poses not finite [{len(truth)}, 3]")
    return np.hypot(poses[:, 0] - truth[:, 0], poses[:, 1] - truth[:, 1])


def phase_realistic():
    """8a: realistic.bag, read by the port's own reader, through the node in
    fast_local (the JAX test's mode) and in rollout_local (K1, 540 beams
    padded to 640), each held to the gate; K1 against its plain version on
    the next solve's inputs.  Returns (the log, the rollout_local node, its
    kernels-line entry)."""
    from ndtpso_slam_tpu_torch.io import importers

    lg = importers.load_log(REALISTIC)
    gt = np.load(REALISTIC_GT)
    check(lg.ranges.shape == (60, 540), f"realistic.bag: ranges {lg.ranges.shape}")
    odo = np.hypot(lg.odoms[:, 0] - gt[:, 0], lg.odoms[:, 1] - gt[:, 1])
    for mode, beams in (("fast_local", 540), ("rollout_local", 640)):
        node, step_s, total, launches, peak = _run_node(
            _real_cfg(lg, cost_mode=mode, max_beams=beams), lg)
        err = _errors(node, gt)
        want = len(lg.ranges) - 1 if mode == "rollout_local" else 0
        check(launches == want, f"8a {mode}: K1 launches {launches}, expected {want}")
        check(err.max() < REAL_GATE_MAX_M and err[-1] < odo[-1],
              f"8a {mode}: max error {err.max():.4f} m, final {err[-1]:.4f} m against the "
              f"odometry's {odo[-1]:.4f} m")
        p50, p95 = _percentiles(step_s)
        print(f"[phase 8a] realistic.bag (60 scans x 540 beams, 48 m / 1 m / 8 slots, P=50 I=30) "
              f"{mode} N={beams}: max err {err.max():.4f} m, mean {err.mean():.4f} m, final "
              f"{err[-1]:.4f} m (odometry {odo[-1]:.4f} m); aligned-step latency p50 {p50:.3f} ms "
              f"p95 {p95:.3f} ms; {len(lg.ranges) / total:.2f} scans/s; K1 launches {launches} "
              f"({launches / len(lg.ranges):.3f} per scan)")
        phase_main_profile(node, lg, tag=f" {mode}", phase="[phase 8a]")
    worst, ms, plain_ms, bnd, cluster, _ = phase_main_kernel(node, lg, tag="[phase 8a]")
    entry = _entry("rollout_local_realistic", SRC + "rollout_local.cu",
                   "ndtpso_slam_tpu/ops/pallas_rollout.py:551", launches, worst, ms, plain_ms,
                   bnd, cluster=cluster, points=640)
    return lg, node, entry


def phase_sparse_patch(lg):
    """8b, 8c and 8f's resume at scan.launch scale, every run under
    deterministic algorithms (the map's scatter-adds use atomics otherwise):
    the dense ring; a sparse ring of RING_ROWS_START rows, doubled until no
    cell overflows, its poses bit-equal to the dense run's and the peak
    memory of both; the stencil patch covering every scan (patch_range_m =
    range_max), its poses bit-equal to the dense run's; and the sparse run
    checkpointed after CHECKPOINT_AT scans, restored into a fresh node and
    run to the end, its poses bit-equal to the uninterrupted run's."""
    import torch

    from ndtpso_slam_tpu_torch.node import SlamNode

    aligns = len(lg.ranges) - 1
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        dense, _, _, d_launch, d_peak = _run_main(lg, False)
        d_max = torch.cuda.max_memory_allocated()
        d_poses = np.stack(dense.poses)
        err = _errors(dense, lg.poses)
        check(err.mean() < GATE_MEAN_M and err.max() < GATE_MAX_M,
              f"8b dense: trajectory gate mean {err.mean():.4f} m, max {err.max():.4f} m")
        del dense
        rows = RING_ROWS_START
        while True:
            sparse, _, _, s_launch, s_peak = _run_main(lg, False, ring_rows=rows)
            s_max = torch.cuda.max_memory_allocated()
            if int(sparse.state.map.ring_overflow) == 0:
                break
            print(f"[phase 8b] ring_rows {rows}: overflow {int(sparse.state.map.ring_overflow)}")
            rows *= 2
        s_poses = np.stack(sparse.poses)
        check(s_launch == aligns and d_launch == aligns,
              f"8b: K1 launches dense {d_launch}, sparse {s_launch}, expected {aligns}")
        check(np.array_equal(s_poses, d_poses), "8b: sparse ring moved a pose: max |dpose| "
              f"{np.abs(s_poses - d_poses).max():.3e}")
        m = sparse.state.map
        slot_mb = lambda st: sum(t.numel() * t.element_size()
                                 for t in (st.slot_sum, st.slot_count, st.slot_cov)) / 1e6
        print(f"[phase 8b] sparse ring at scan.launch scale: ring_rows {rows}, ring_used "
              f"{int(m.ring_used)}, ring_overflow {int(m.ring_overflow)}; poses bit-equal to the "
              f"dense ring's (deterministic algorithms), mean err {err.mean():.4f} m, max "
              f"{err.max():.4f} m; K1 launches {s_launch}; slot arrays {slot_mb(m):.1f} MB "
              f"(dense {(360001 * 100 * 24) / 1e6:.1f} MB); peak device memory over the run's "
              f"start: dense {d_peak / 2**30:.4f} GiB, sparse {s_peak / 2**30:.4f} GiB (drop "
              f"{(d_peak - s_peak) / 2**30:.4f} GiB); torch.cuda.max_memory_allocated: dense "
              f"{d_max / 2**30:.4f} GiB, sparse {s_max / 2**30:.4f} GiB")

        patched, step_s, _, p_launch, _ = _run_main(lg, False, patch_range_m=float(lg.range_max))
        ps = patched.slam_cfg.map.stencil_patch_cells
        p_poses = np.stack(patched.poses)
        check(0 < ps < patched.slam_cfg.map.cells_per_side, f"8c: patch side {ps}")
        check(p_launch == aligns, f"8c: K1 launches {p_launch}")
        check(np.array_equal(p_poses, d_poses), "8c: the covering patch moved a pose: max "
              f"|dpose| {np.abs(p_poses - d_poses).max():.3e}")
        p50, p95 = _percentiles(step_s)
        print(f"[phase 8c] stencil patch at scan.launch scale: patch_range_m {lg.range_max} -> "
              f"{ps} x {ps} cells of {patched.slam_cfg.map.cells_per_side}; poses bit-equal to "
              f"the unpatched run's (deterministic algorithms); K1 launches {p_launch}; "
              f"aligned-step latency p50 {p50:.3f} ms p95 {p95:.3f} ms")
        del patched

        with tempfile.TemporaryDirectory(dir=HERE) as tmp:
            cfg = sparse.cfg
            first, _, _, a_launch, _ = _run_node(cfg, lg, range(CHECKPOINT_AT))
            path = os.path.join(tmp, "sparse.npz")
            first.save_checkpoint(path)
            size = os.path.getsize(path)
            resumed = SlamNode(cfg, verbose=False)
            resumed.load_checkpoint(path)
            resumed, _, _, b_launch, _ = _run_node(cfg, lg, range(CHECKPOINT_AT, len(lg.ranges)),
                                                   node=resumed)
        r_poses = np.concatenate([np.stack(first.poses), np.stack(resumed.poses)])
        check(np.array_equal(r_poses, s_poses), "8f: the resumed run moved a pose: max |dpose| "
              f"{np.abs(r_poses - s_poses).max():.3e}")
        check(a_launch + b_launch == aligns, f"8f: K1 launches {a_launch} + {b_launch}")
        check(int(resumed.state.map.ring_used) == int(m.ring_used), "8f: ring_used differs")
        print(f"[phase 8f] sparse run checkpointed after {CHECKPOINT_AT} scans ({size} bytes), "
              f"restored into a fresh node, run to the end: poses bit-equal to the uninterrupted "
              f"sparse run's; K1 launches {a_launch} + {b_launch}")
    finally:
        torch.use_deterministic_algorithms(False)


def phase_frontal(lg):
    """8d: PREFER_FRONTAL_POINTS at scan.launch scale in rollout_local:
    phase 4's gate, K1's launches and the beams kept per scan."""
    import torch

    from ndtpso_slam_tpu_torch.models import scan as scan_mod

    node, step_s, _, launches, _ = _run_main(lg, False, prefer_frontal_points=True)
    err = _errors(node, lg.poses)
    check(launches == len(lg.ranges) - 1, f"8d: K1 launches {launches}")
    check(err.mean() < GATE_MEAN_M and err.max() < GATE_MAX_M,
          f"8d: trajectory gate mean {err.mean():.4f} m, max {err.max():.4f} m")
    cfg = node.slam_cfg
    plain = _main_cfg(lg).slam_config()
    kept = [[int(scan_mod.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max,
                                     c.scan, c.map).valid.sum()) for r in lg.ranges]
            for c in (cfg, plain)]
    check(cfg.scan.prefer_frontal_points and all(0 < a < b for a, b in zip(*kept)),
          "8d: decimation kept no beam or every beam")
    p50, p95 = _percentiles(step_s)
    print(f"[phase 8d] prefer_frontal_points at scan.launch scale: mean err {err.mean():.4f} m, "
          f"max {err.max():.4f} m; beams kept per scan mean {np.mean(kept[0]):.1f} (min "
          f"{min(kept[0])}, max {max(kept[0])}) of {np.mean(kept[1]):.1f} valid; K1 launches "
          f"{launches}; aligned-step latency p50 {p50:.3f} ms p95 {p95:.3f} ms")
    torch.cuda.synchronize()


def phase_glir(real_lg, world):
    """8e: GLIR-PSO.  The node in local_exact on realistic.bag (tests/
    test_node.py's plausibility gate), under deterministic algorithms;
    solve_batch(optimizer="glir") at B=16 in fast, each solve its B=1 call;
    and GLIR with rollout_local refused, in the node and in solve_batch.

    GLIR's ratio attractors amplify an ulp of the map into centimetres
    within a few scans, and its 60-scan max error on the bag has a long
    tail in both packages (PERF.md §7: the JAX package 0.15-0.89 m over
    8 seeds on the CPU, the port 0.16-1.42 m; on the card 0.16-0.95 m over
    16 runs with the map's atomic scatter-adds, once 5.20 m).  So the gated
    run is the reproducible one: the map update is one kernel that adds in
    index order (one launch a scan), the other ops deterministic."""
    import torch

    from ndtpso_slam_tpu_torch.node import SlamNode
    from ndtpso_slam_tpu_torch.parallel import mesh

    gt = np.load(REALISTIC_GT)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        node, step_s, _, launches, _ = _run_node(
            _real_cfg(real_lg, cost_mode="local_exact", optimizer="glir", max_beams=540),
            real_lg)
    finally:
        torch.use_deterministic_algorithms(False)
    counts = _read_counts()
    err = _errors(node, gt)
    check(err.max() < GLIR_GATE_MAX_M, f"8e: GLIR node max error {err.max():.4f} m")
    want = {n: len(real_lg.ranges) * int(n == "ndt_ingest") for n in counts}
    check(counts == want, f"8e: GLIR node launched {counts}, expected {want}")
    p50, p95 = _percentiles(step_s)
    print(f"[phase 8e] GLIR node, local_exact, realistic.bag, deterministic algorithms: max err "
          f"{err.max():.4f} m (gate {GLIR_GATE_MAX_M} m), mean "
          f"{err.mean():.4f} m; aligned-step latency p50 {p50:.3f} ms p95 {p95:.3f} ms; no "
          f"solver kernel launched (plain PyTorch), the map update {counts['ndt_ingest']} "
          f"ndt_ingest launches")

    sub = _first(world, BATCH_SMALL)
    cfg = sub["pso_cfg"]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = mesh.solve_batch(*sub["args"], sub["map_cfg"], cfg, "fast", optimizer="glir")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    pose = res.pose.cpu().numpy()
    check(pose.shape == (BATCH_SMALL, 3), f"8e: GLIR batch poses {pose.shape}")
    check(not any(counts.values()), f"8e: GLIR batch launched {counts}")
    keys, guesses, devs, snaps, points, valid = sub["args"]
    one = mesh.solve_batch(keys[:1], guesses[:1], devs[:1], type(snaps)(
        snaps.mean[:1], snaps.inv_cov[:1], snaps.built[:1]), points[:1], valid[:1],
        sub["map_cfg"], cfg, "fast", optimizer="glir")
    same = lambda a, b: np.array_equal(a.cpu().numpy(), b.cpu().numpy(), equal_nan=True)
    check(same(one.pose[0], res.pose[0]) and same(one.cost[0], res.cost[0]),
          "8e: solve 0 of the batch differs from its B=1 call")
    # GLIR's ratio attractors can fling particles far out, where the frozen
    # cost's clamp scores them as the JAX package's does: its poses are
    # reported, not gated (the bench.py gate is the deployed PSO's).
    errs = np.abs(pose - sub["true"])
    print(f"[phase 8e] solve_batch fast optimizer=glir B={BATCH_SMALL} P={cfg.population} "
          f"I={cfg.iterations} N=384: {int(np.isfinite(pose).all(1).sum())} of {BATCH_SMALL} "
          f"poses finite; median xy err {np.median(errs[:, :2]):.4f} m, median th "
          f"{np.median(errs[:, 2]):.5f} rad, max xy {errs[:, :2].max():.4g} m; {wall:.3f} s; "
          f"solve 0 bit-equal to its B=1 call; no kernel launched")
    for refuse in (lambda: SlamNode(_real_cfg(real_lg, cost_mode="rollout_local", max_beams=640,
                                              optimizer="glir"), verbose=False),
                   lambda: mesh.solve_batch(*sub["args"], sub["map_cfg"], cfg, "rollout_local",
                                            optimizer="glir")):
        try:
            refuse()
        except ValueError as e:
            check("rollout" in str(e) or "glir" in str(e), f"8e: refusal message {e}")
        else:
            check(False, "8e: GLIR with rollout_local was not refused")
    print("[phase 8e] GLIR with rollout_local refused (ValueError) by the node and solve_batch")


def phase_export(lg):
    """8f: the export bundle of a realistic.bag run in rollout_local with the
    occupancy raster on and the map image: the files' names and sizes, the
    PNGs decoded."""
    from ndtpso_slam_tpu_torch.utils import export

    node, _, _, launches, _ = _run_node(
        _real_cfg(lg, cost_mode="rollout_local", max_beams=640, build_og=True,
                  save_map_images=True), lg)
    check(launches == len(lg.ranges) - 1, f"8f: K1 launches {launches}")
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        t0 = time.perf_counter()
        files = node.shutdown(os.path.join(tmp, "real"))
        wall = time.perf_counter() - t0
        names = {os.path.basename(f): os.path.getsize(f) for f in files}
        for suffix in (".pose.csv", ".map.csv", ".gnuplot", ".cells.csv", "ppm.png",
                       "occupancy-grid.png"):
            check(any(n.endswith(suffix) and size > 0 for n, size in names.items()),
                  f"8f: no {suffix} in {sorted(names)}")
        rows = sum(1 for _ in open(os.path.join(tmp, "real.pose.csv"))) - 1
        check(rows == len(lg.ranges), f"8f: {rows} pose rows")
        shapes = [export.read_png(f).shape for f in files if f.endswith(".png")]
    print(f"[phase 8f] export bundle in {wall:.2f} s: "
          + ", ".join(f"{n} {size} B" for n, size in sorted(names.items()))
          + f"; PNGs decode to {shapes}")


def phase_whole_node(lg_main, world):
    """Phase 8, the whole node.  Returns 8a's kernels-line entry."""
    t0 = time.perf_counter()
    real_lg, _, entry = phase_realistic()
    phase_sparse_patch(lg_main)
    phase_frontal(lg_main)
    phase_glir(real_lg, world)
    phase_export(real_lg)
    print(f"[phase 8] wall {time.perf_counter() - t0:.1f} s")
    return entry


# ---------------------------------------------------------------- phase 9

# 9a: bench.py's slam_fullscale_8robots_r8192_flat_rollout_local workload
# (bench.py:400-410, 445-487): 8 robots, 50 scans each, a sparse ring of
# 8,192 rows, keys [3, 9 + r].
FLEET_B = 8
FLEET_SCANS = 50
FLEET_RING_ROWS = 8192
FLEET_K2_SCANS = 8
FLEET_PROFILE_STEPS = 10
# 9b: two sensors' logs at their rates: (name, period s, scans, heading).
DUO = (("front", 0.1, 20, 0.0), ("back", 0.2, 10, float(np.pi)))
DUO_LAUNCH = ("launch/lidar_front.json", "launch/lidar_back.json")
# 9c: the robot of the pool that gets 7c's kidnapped scan.
KIDNAP_ROBOT = 3


def _fleet_cfg(cost_mode="rollout_local"):
    """9a's configuration: scan.launch scale with a sparse ring."""
    from ndtpso_slam_tpu_torch import config as C

    return C.SlamConfig(pso=C.PSOConfig(iterations=30, population=50),
                        map=C.MapConfig(size_m=300.0, cell_side_m=0.5, window_slots=100,
                                        ring_rows=FLEET_RING_ROWS),
                        scan=C.ScanConfig(max_beams=384), cost_mode=cost_mode)


def fleet_world(dev, b=FLEET_B, n_scans=FLEET_SCANS):
    """9a's logs (make_log(seed=2 + r, 50 scans, world_size=50)), their
    scans on ``dev`` [B, T, 384, ...], the start poses and the keys."""
    import torch

    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.models import scan as scan_mod

    cfg = _fleet_cfg()
    logs = [synthetic.make_log(seed=2 + r, n_scans=n_scans, n_beams=360, world_size=50.0)
            for r in range(b)]
    loaded = [[scan_mod.load_laser(x, lg.angle_min, lg.angle_increment, lg.range_max, cfg.scan,
                                   cfg.map, device=dev) for x in lg.ranges] for lg in logs]
    stack = lambda name: torch.stack([torch.stack([getattr(s, name) for s in row])
                                      for row in loaded])
    return dict(logs=logs, scans=scan_mod.Scan(points=stack("points"), valid=stack("valid")),
                init=np.stack([lg.poses[0] for lg in logs]).astype(np.float32),
                keys=np.stack([np.full(b, 3), np.arange(9, 9 + b)], -1), dev=dev)


def _steps(scans, t):
    from ndtpso_slam_tpu_torch.models.scan import Scan

    return Scan(points=scans.points[:, :t], valid=scans.valid[:, :t])


@contextlib.contextmanager
def _solves_logged(kernel):
    """Within: the fleet's and the solo step's calls of solve_rollout_mode
    (models/solve.py) recorded: log["cs"] the cluster size of each call's
    launch (``kernel.LAST_CLUSTER``), log["args"] the last call's
    arguments."""
    from unittest import mock

    from ndtpso_slam_tpu_torch.models import slam, solve
    from ndtpso_slam_tpu_torch.parallel import fleet

    log = {"cs": [], "args": None}

    def recording(*args):
        out = solve.solve_rollout_mode(*args)
        log["cs"].append(kernel.LAST_CLUSTER)
        log["args"] = args
        return out

    with mock.patch.object(fleet, "solve_rollout_mode", recording), \
            mock.patch.object(slam, "solve_rollout_mode", recording):
        yield log


def _fleet_vs_solo(w, cfg, n_scans, kernel_name):
    """Under deterministic algorithms: the fleet over the first n_scans
    scans, then each robot's solo run_offline.  Each robot's poses must be
    bit-equal to its solo run's where every fleet launch of the kernel ran at
    the solo launches' cluster size, else within phase 3's tolerance, with
    the reason printed.  Returns (the launch counts of the fleet run, the
    arguments of its last solve_rollout_mode call, its cluster sizes)."""
    import torch

    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.models import slam
    from ndtpso_slam_tpu_torch.parallel import fleet

    scans = _steps(w["scans"], n_scans)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with _solves_logged(_launch_counts()[kernel_name]) as log:
            _reset_counts()
            states = slam.init_slam_batch(cfg, w["init"], w["dev"])
            _, fposes, _ = fleet.run_offline_fleet(states, scans, w["keys"], cfg)
            torch.cuda.synchronize()
            counts = _read_counts()
            del states
            fleet_cs = sorted(set(log["cs"]))
            last_args = log["args"]
            equal, worst, solo_cs = 0, 0.0, set()
            for r in range(len(w["init"])):
                log["cs"].clear()
                st = slam.init_slam(cfg, tuple(w["init"][r]), w["dev"])
                _, sposes, _ = slam.run_offline(st, scan_mod.Scan(points=scans.points[r],
                                                                  valid=scans.valid[r]),
                                                tuple(int(k) for k in w["keys"][r]), cfg)
                cs = set(log["cs"])
                solo_cs |= cs
                diff = float((fposes[r] - sposes).abs().max())
                worst = max(worst, diff)
                if cs == set(fleet_cs):
                    check(torch.equal(fposes[r], sposes),
                          f"9a {cfg.cost_mode}: robot {r} differs from its solo run at equal "
                          f"cluster size {fleet_cs}: max |dpose| {diff:.3e}")
                    equal += 1
                else:
                    check(diff <= TRAJ_ATOL, f"9a {cfg.cost_mode}: robot {r} vs solo {diff:.3e}")
                    print(f"[phase 9a] {cfg.cost_mode} robot {r}: the fleet launched at C "
                          f"{fleet_cs}, its solo run at C {sorted(cs)}: summed in other orders, "
                          f"held to {TRAJ_ATOL} (max |dpose| {diff:.3e})")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[phase 9a] {cfg.cost_mode} fleet of {len(w['init'])} x {n_scans} scans against the "
          f"solo runs (deterministic algorithms): {equal} of {len(w['init'])} robots bit-equal "
          f"(fleet C {fleet_cs}, solo C {sorted(solo_cs)}), max |dpose| {worst:.3e}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return counts, last_args, fleet_cs


def _fleet_scatter(w, cfg, states):
    """9a: the row_scatter calls of one fleet step (the step after the run,
    on its state and the next scan's ids) against the plain version and the
    six indexed assignments they replace (phase 6d's three ways,
    ``_time_split``: CUDA events back to back, device busy per call, host
    time), on copies of the fields."""
    from unittest import mock

    import torch

    from ndtpso_slam_tpu_torch.ops import row_scatter as rsc
    from ndtpso_slam_tpu_torch.parallel import fleet

    from ndtpso_slam_tpu_torch.models.scan import Scan

    calls = []
    with mock.patch.object(fleet, "row_scatter",
                           lambda ops, idx, vals: calls.append((ops, idx, vals)) or ops):
        fleet.fleet_pool_step(states, Scan(points=w["scans"].points[:, -1],
                                           valid=w["scans"].valid[:, -1]),
                              w["keys"], np.ones(len(w["init"]), bool), cfg)
    check(len(calls) == 2, f"9a: {len(calls)} row_scatter calls in a fleet step, expected 2")
    copies = lambda: [([op.clone() for op in ops], idx, vals) for ops, idx, vals in calls]
    kern, plain, indexed = copies(), copies(), copies()
    for (ko, idx, vals), (po, _, _), (io, _, _) in zip(kern, plain, indexed):
        rsc.row_scatter(ko, idx, vals)
        rsc.row_scatter_reference(po, idx, vals)
        for op, v in zip(io, vals):
            op[idx] = v
        check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(ko, po, io)),
              "9a: the fleet's row_scatter differs from its plain version or indexed assignment")
    fn_k = lambda: [rsc.row_scatter(o, i, v) for o, i, v in kern]
    fn_p = lambda: [rsc.row_scatter_reference(o, i, v) for o, i, v in plain]
    fn_i = lambda: [op.__setitem__(i, x) for o, i, v in indexed for op, x in zip(o, v)]
    # Device busy as phase 6d takes it: the mean recorded launch times the
    # launches of a call (late in a run the profiler drops records).
    kt, it = _time_split(fn_k, 50, 2), _time_split(fn_i, 50, 6)
    plain_ms = _events_ms(fn_p, 5)
    m = calls[0][1].shape[0]
    nbytes = sum(8.0 * m + 2 * len(ops) * 4.0 * ops[0].shape[1] * int(torch.unique(idx).numel())
                 for ops, idx, _ in calls)
    bnd = bound(nbytes)
    print(f"[phase 9a] row_scatter on one fleet step's ids (M={m} rows, W=2 and W=3, 3 fields "
          f"each, {calls[0][0][0].shape[0]} rows per field): kernel = plain = indexed "
          f"assignment bit for bit; the 2 launches {kt['ms']:.4f} ms back to back (events), "
          f"device busy {kt['device_ms']:.4f} ms per step ({kt['device_ops']:.1f} operations "
          f"recorded per call), host {kt['host_us']:.1f} us; the 6 indexed assignments "
          f"{it['ms']:.4f} ms, device busy {it['device_ms']:.4f} ms ({it['device_ops']:.1f} "
          f"operations recorded), host {it['host_us']:.1f} us; plain {plain_ms:.3f} ms; bound "
          f"{bnd[0]:.5f} ms ({bnd[1]})")
    return kt, it, plain_ms, bnd


def phase_fleet(dev):
    """9a: the flat fleet at deployment scale.  Returns the kernels-line
    entries of K1 in the fleet and of row_scatter on the fleet build."""
    import torch

    from ndtpso_slam_tpu_torch.models import slam
    from ndtpso_slam_tpu_torch.models.scan import Scan
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.parallel import fleet
    from ndtpso_slam_tpu_torch.parallel.sessions import SlamSessionPool

    cfg = _fleet_cfg()
    w = fleet_world(dev)
    b, t = w["scans"].valid.shape[:2]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    states = slam.init_slam_batch(cfg, w["init"], dev)
    _reset_counts()
    t0 = time.perf_counter()
    states, poses, _ = fleet.run_offline_fleet(states, w["scans"], w["keys"], cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    want = {n: {"rollout_local": t - 1, "row_scatter": 2 * t}.get(n, 0) for n in counts}
    check(counts == want, f"9a: launches {counts}, expected {want}")
    p = poses.cpu().numpy()
    check(np.isfinite(p).all() and p.shape == (b, t, 3), "9a: poses not finite [B, T, 3]")
    gt = np.stack([lg.poses for lg in w["logs"]])
    err = np.hypot(p[..., 0] - gt[..., 0], p[..., 1] - gt[..., 1])
    check((err.mean(axis=1) < GATE_MEAN_M).all() and (err.max(axis=1) < GATE_MAX_M).all(),
          f"9a: per-robot gate: mean {err.mean(axis=1).round(4)}, max {err.max(axis=1).round(4)}")
    used = states.map.ring_used.cpu().numpy()
    check((states.map.ring_overflow == 0).all().item(), "9a: the sparse ring overflowed")

    # The step's latency through the session pool: each poll ends in the
    # poses' copy to the host.
    pool = SlamSessionPool(cfg, w["init"], w["keys"], dev)
    poll_s = []
    for i in range(t):
        for r in range(b):
            pool.submit(r, Scan(points=w["scans"].points[r, i], valid=w["scans"].valid[r, i]))
        ts = time.perf_counter()
        pool.poll()
        poll_s.append(time.perf_counter() - ts)
    p50, p95 = _percentiles(poll_s)
    del pool

    # Device kernels per fleet step: the last scans fed again.
    idx = range(t - FLEET_PROFILE_STEPS, t)
    rows, prof_wall = _trace(lambda: [fleet.fleet_pool_step(
        states, Scan(points=w["scans"].points[:, i], valid=w["scans"].valid[:, i]), w["keys"],
        np.ones(b, bool), cfg) for i in idx])
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    kern_per_step = sum(e.count for e in rows) / FLEET_PROFILE_STEPS
    busy = sum(dev_us(e) for e in rows) / 1e3 / FLEET_PROFILE_STEPS
    mc, pc = cfg.map, cfg.pso
    print(f"[phase 9a] flat fleet, {b} robots x {t} scans ({mc.size_m:.0f} m / {mc.cell_side_m} m"
          f" / {mc.window_slots} slots, sparse ring {mc.ring_rows} rows, P={pc.population} "
          f"I={pc.iterations} N={cfg.scan.max_beams}, {cfg.cost_mode}): per-robot mean err "
          f"{err.mean(axis=1).round(4).tolist()} m, max {err.max(axis=1).round(4).tolist()} m "
          f"(gate {GATE_MEAN_M} / {GATE_MAX_M}); {b * t / wall:.2f} scans/s aggregate "
          f"({wall:.3f} s for {b * t}); pool step latency p50 {p50:.3f} ms p95 {p95:.3f} ms; "
          f"launches {counts['rollout_local']} K1, {counts['row_scatter']} row_scatter; peak "
          f"device memory {peak / 2**30:.3f} GiB; ring rows used {used.tolist()}")
    print(f"[phase 9a] profiled, {FLEET_PROFILE_STEPS} more fleet steps: {kern_per_step:.1f} "
          f"device kernels per step, busy {busy:.3f} of {prof_wall / FLEET_PROFILE_STEPS:.3f} "
          f"ms per step ({100 * busy * FLEET_PROFILE_STEPS / prof_wall:.1f}%)")
    scatter = _fleet_scatter(w, cfg, states)
    del states

    _, k1_args, fleet_cs = _fleet_vs_solo(w, cfg, t, "rollout_local")
    counts2, k2_args, _ = _fleet_vs_solo(w, _fleet_cfg("rollout"), FLEET_K2_SCANS, "rollout")
    check(counts2["rollout"] == FLEET_K2_SCANS - 1, f"9a rollout: K2 launches {counts2}")
    k2 = _fleet_k2(k2_args, counts2["rollout"])

    _, keys, guesses, devs, snaps, points, valid, mc, pso_cfg, _ = k1_args
    sten, pts = _pack_local(snaps, mc, guesses, points, valid)
    dpose, dcost = compare_kernel(keys, guesses, devs, sten, pts, pso_cfg, mc)
    ms = _events_ms(lambda: rl.pso_rollout_local(keys, guesses, devs, sten, pts, pso_cfg, mc), 50)
    cluster = rl.pso_rollout_local.LAST_CLUSTER
    one = lambda i: (keys[i:i + 1], guesses[i:i + 1], devs[i:i + 1], sten[i:i + 1], pts[i:i + 1])
    ms_b1 = _events_ms(lambda: [rl.pso_rollout_local(*one(i), pso_cfg, mc) for i in range(b)], 20)
    plain_ms = _events_ms(lambda: rl.pso_rollout_local_reference(keys, guesses, devs, sten, pts,
                                                                 pso_cfg, mc), 2)
    bnd = _rollout_local_bound(sten, pts, pso_cfg.population, [pso_cfg.iterations] * b)
    print(f"[phase 9a] K1 on the fleet's last solve (B={b}, N={pts.shape[1]}): kernel vs plain "
          f"max |dpose| {dpose:.3e} max |dcost| {dcost:.3e}; {ms:.4f} ms at B={b} (C={cluster}) "
          f"against {ms_b1:.4f} ms for {b} B=1 launches; plain {plain_ms:.3f} ms; bound "
          f"{bnd[0]:.6f} ms ({bnd[1]}, {100 * bnd[0] / ms:.2f}% of it)")
    k1 = _entry("rollout_local_fleet", SRC + "rollout_local.cu",
                "ndtpso_slam_tpu/ops/pallas_rollout.py:551", counts["rollout_local"],
                max(dpose, dcost), ms, plain_ms, bnd, cluster=cluster, batch=b, b1_x8_ms=ms_b1)
    kt, it, s_plain, s_bnd = scatter
    rs = _entry("row_scatter_fleet", SRC + "row_scatter.cu", "experiments/scatter_unique_ab.py:63",
                counts["row_scatter"], 0.0, kt["ms"], s_plain, s_bnd, calls_per_step=2,
                device_ms=kt["device_ms"], host_us=kt["host_us"], indexed_assignment=it)
    return k1, k2, rs


def _fleet_k2(args, launches):
    """9a: K2 on the rollout fleet's last solve (its recorded
    solve_rollout_mode arguments, B = the aligning robots), against its
    plain version at the launch's cluster size with phase 5a's rollout
    tolerances, timed.  Returns its kernels-line entry."""
    import torch

    from ndtpso_slam_tpu_torch.models import cost
    from ndtpso_slam_tpu_torch.ops import rollout as ro

    _, keys, guesses, devs, snaps, points, valid, mc, pso_cfg, ee = args
    b = keys.shape[0]
    sten, pts = ro.pack_rollout_inputs(cost.bind_neighborhood(guesses, snaps, points, valid, mc),
                                       points)
    packed = (keys, guesses, devs, sten, pts, pso_cfg, mc)
    kern = lambda: ro.pso_rollout(*packed, early_exit=ee)
    got = kern()
    torch.cuda.synchronize()
    cluster = ro.pso_rollout.LAST_CLUSTER
    plain = lambda: ro.pso_rollout_reference(*packed, early_exit=ee, cluster=cluster or 1)
    ref, binds = _recorded_binds(plain)
    dpose, dcost = _compare(f"9a rollout fleet B={b}", got, ref, *_TOLERANCES["rollout"])
    ms = _events_ms(kern, 20)
    plain_ms = _events_ms(plain, 2)
    live = _live_iterations(binds, ee, pso_cfg.iterations)
    bnd = _rollout_bound(sten, pts, pso_cfg.population, live)
    print(f"[phase 9a] K2 on the rollout fleet's last solve (B={b}, N={pts.shape[-1]}, "
          f"P={pso_cfg.population}, I={pso_cfg.iterations}): kernel vs plain at C={cluster} max "
          f"|dpose| {dpose:.3e} max |dcost| {dcost:.3e}; {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bnd[0]:.6f} ms ({bnd[1]}, {100 * bnd[0] / ms:.2f}% of it)")
    return _entry("rollout_fleet", SRC + "rollout.cu", "ndtpso_slam_tpu/ops/pallas_rollout.py:111",
                  launches, max(dpose, dcost), ms, plain_ms, bnd, cluster=cluster, batch=b)


def _duo_logs(tmp):
    """9b's two .npz logs: each sensor from its launch file's pose, driving
    straight on at 0.4 m/s, at its own rate."""
    from ndtpso_slam_tpu_torch.io import synthetic

    paths, logs = [], []
    for i, (name, dt, n, heading) in enumerate(DUO):
        ts = np.arange(n) * dt
        traj = np.stack([0.4 * ts * np.cos(heading), 0.4 * ts * np.sin(heading),
                         np.full_like(ts, heading)], -1)
        lg = synthetic.make_log(seed=40 + i, n_scans=n, n_beams=360, world_size=40.0, dt=dt,
                                trajectory=traj)
        path = os.path.join(tmp, f"{name}.npz")
        np.savez(path, ranges=lg.ranges, poses=lg.poses, odoms=lg.odoms, timestamps=lg.timestamps,
                 angle_min=lg.angle_min, angle_increment=lg.angle_increment,
                 range_max=lg.range_max)
        paths.append(path)
        logs.append(lg)
    return paths, logs


def phase_sessions_cli(dev):
    """9b: two sensors' logs through the CLI as two sessions (a subprocess,
    deterministic algorithms), its bundles, and each session's pose CSV
    against a solo SlamNode of seed + 101·i in this process."""
    import dataclasses

    import torch

    from ndtpso_slam_tpu_torch.node import MultiSessionNode, NodeConfig, SlamNode
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    over = dict(cost_mode="rollout_local", max_beams=384)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        paths, logs = _duo_logs(tmp)
        # The CLI's main under deterministic algorithms, so that the map's
        # scatter-adds sum in the solo node's order.
        cmd = [sys.executable, "-c", "import sys, torch; "
               "torch.use_deterministic_algorithms(True, warn_only=True); "
               "from ndtpso_slam_tpu_torch.node import main; sys.exit(main(sys.argv[1:]))"]
        for path in paths:
            cmd += ["--scanlog", path]
        for launch in DUO_LAUNCH:
            cmd += ["--config", os.path.join(HERE, launch)]
        cmd += ["--cost-mode", "rollout_local", "--max-beams", "384", "--quiet", "--device", str(dev), "--out", os.path.join(tmp, "duo")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, PYTHONPATH=HERE))
        wall = time.perf_counter() - t0
        check(res.returncode == 0, f"9b: the CLI exited {res.returncode}: {res.stderr[-2000:]}")
        names = sorted(os.listdir(tmp))
        for i in range(len(DUO)):
            for suffix in (".pose.csv", ".map.csv", ".gnuplot", ".cells.csv"):
                check(f"duo-s{i}{suffix}" in names, f"9b: no duo-s{i}{suffix} in {names}")
        cfgs = [NodeConfig.from_json(os.path.join(HERE, launch), **over) for launch in DUO_LAUNCH]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with _solves_logged(rl.pso_rollout_local) as log:
                MultiSessionNode(cfgs, verbose=False, device=dev).run_logs(logs)
                pool_cs = set(log["cs"])
                solo_cs, errs = set(), []
                for i, (cfg, lg) in enumerate(zip(cfgs, logs)):
                    log["cs"].clear()
                    solo = SlamNode(dataclasses.replace(cfg, seed=cfg.seed + 101 * i),
                                    verbose=False, device=dev)
                    solo.run_log(lg)
                    solo.shutdown(os.path.join(tmp, f"solo{i}"))
                    solo_cs |= set(log["cs"])
                    errs.append(float(np.hypot(*(np.stack(solo.poses)[:, :2]
                                                 - lg.poses[:, :2]).T).max()))
        finally:
            torch.use_deterministic_algorithms(False)
        read = lambda name: open(os.path.join(tmp, name)).read()
        for i in range(len(DUO)):
            got, want = read(f"duo-s{i}.pose.csv"), read(f"solo{i}.pose.csv")
            if pool_cs == solo_cs:
                check(got == want, f"9b: session {i}'s pose CSV differs from its solo node's "
                      f"at equal cluster size {sorted(pool_cs)}")
            else:
                rows = lambda text: np.array([[float(v) for v in line.split(",")]
                                              for line in text.strip().split("\n")[1:]])
                diff = float(np.abs(rows(got) - rows(want)).max())
                check(diff <= TRAJ_ATOL, f"9b: session {i} vs solo {diff:.3e}")
                print(f"[phase 9b] session {i}: the pool launched K1 at C {sorted(pool_cs)}, "
                      f"the solo node at C {sorted(solo_cs)}: held to {TRAJ_ATOL} ({diff:.3e})")
    sensors = ", ".join(f"{name} {n} scans at {1 / dt:.0f} Hz" for name, dt, n, _ in DUO)
    print(f"[phase 9b] CLI, 2 sessions ({sensors}; {' + '.join(DUO_LAUNCH)}, rollout_local, "
          f"N=384): exit 0 in {wall:.2f} s (a fresh "
          f"process), bundles duo-s0.* and duo-s1.* written, each pose CSV "
          f"{'identical to' if pool_cs == solo_cs else 'within tolerance of'} its solo node's "
          f"(K1 C {sorted(pool_cs)} in the pool, {sorted(solo_cs)} solo); max error against the "
          f"truth {[round(e, 4) for e in errs]} m")


def _pool_of(cfg, st, n, keys, dev):
    """A session pool of n sessions, each a copy of solo state st."""
    import dataclasses

    from ndtpso_slam_tpu_torch.models import slam
    from ndtpso_slam_tpu_torch.parallel.sessions import SlamSessionPool

    pool = SlamSessionPool(cfg, np.tile(st.pose.cpu().numpy(), (n, 1)), keys, dev)
    for i in range(n):
        view = slam.session_state(pool.states, i)
        for f in dataclasses.fields(st.map):
            getattr(view.map, f.name).copy_(getattr(st.map, f.name))
        slam.set_session_state(pool.states, i, st)
    return pool


def phase_fleet_recovery(dev, window_slots=100):
    """9c: 7c's kidnap in a pool of 8 sessions with recovery on: one
    accepted recovery for the kidnapped robot within 7c's gate, the other
    robots' map rows bit-equal before and after the escalation, the event's
    wall time and K3's launches; the same escalation at other keys
    (reported, not gated: ROADMAP R5)."""
    import dataclasses
    from unittest import mock

    import torch

    from ndtpso_slam_tpu_torch.models import ndt_map, slam
    from ndtpso_slam_tpu_torch.parallel import fleet, sessions

    cfg, st, healthy, kidnapped, kid_pose = reloc_launch_world(dev, window_slots)
    b = FLEET_B
    keys = np.stack([np.full(b, 3), np.arange(9, 9 + b)], -1)
    pool = _pool_of(cfg, st, b, keys, dev)
    for r in range(b):
        pool.submit(r, kidnapped if r == KIDNAP_ROBOT else healthy)
    others = [r for r in range(b) if r != KIDNAP_ROBOT]
    seen = {}
    real = fleet.relocalize_fleet_robot

    def escalation(states, idx, scan, key, cfg_):
        before = {f.name: getattr(states.map, f.name)[others].clone()
                  for f in dataclasses.fields(states.map)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(states, idx, scan, key, cfg_)
        torch.cuda.synchronize()
        seen.update(ms=(time.perf_counter() - t0) * 1e3, idx=idx, key=key, accepted=out[3],
                    untouched=all(torch.equal(v, getattr(states.map, k)[others])
                                  for k, v in before.items()))
        return out

    torch.cuda.synchronize()
    _reset_counts()
    with mock.patch.object(sessions, "relocalize_fleet_robot", escalation):
        res = pool.poll()
    counts = _read_counts()
    rec = pool.states.recoveries
    check(seen.get("idx") == KIDNAP_ROBOT, f"9c: escalated {seen}, expected robot {KIDNAP_ROBOT}")
    err = _kidnap_err(torch.as_tensor(res[KIDNAP_ROBOT][0]), kid_pose)
    within = all(e < g for e, g in zip(err, KIDNAP_GATE))
    check(rec[KIDNAP_ROBOT] == 1 and rec.sum() == 1 and within,
          f"9c: recoveries {rec.tolist()}, robot {KIDNAP_ROBOT} err {err.round(4)} "
          f"(gate {KIDNAP_GATE})")
    check(seen["untouched"], "9c: the escalation wrote another robot's map rows")
    evals = 2 * (cfg.recovery.pso.iterations + 2)
    want = {n: {"rollout_local": 1, "score": evals, "reloc_step": evals, "row_scatter": 4}.get(n, 0)
            for n in counts}
    check(counts == want, f"9c: launches {counts}, expected {want}")
    # The escalation at other keys, on the kidnapped robot's views (the
    # pool's state after the step), reported.
    view = slam.session_state(pool.states, KIDNAP_ROBOT)
    snap = ndt_map.snapshot(view.map, cfg.map)
    sweep = []
    for key in KIDNAP_SWEEP:
        rpose, _ = slam._relocalize(key, snap, kidnapped, view.pose, view.pose, cfg)
        sweep.append(all(e < g for e, g in zip(_kidnap_err(rpose, kid_pose), KIDNAP_GATE)))
    print(f"[phase 9c] 7c's kidnap in a pool of {b} sessions (300 m / 0.5 m / {window_slots} "
          f"slots, recovery on, rollout_local): robot {KIDNAP_ROBOT} relocalized by host "
          f"escalation, "
          f"recoveries {rec.tolist()}, err {err.round(4)} (gate {KIDNAP_GATE}); the other "
          f"{len(others)} robots' map rows bit-equal before and after the escalation; "
          f"escalation {seen['ms']:.3f} ms ({'within' if seen['ms'] < PERIOD_MS else 'OVER'} the "
          f"{PERIOD_MS:.0f} ms period); launches {counts} (K3 "
          f"{counts['score']}); the escalation's relocalization at {len(sweep)} other keys: "
          f"{sum(sweep)} within the gate")
    del pool


def phase_fleets_sessions(dev):
    """Phase 9: fleets and sessions.  Returns 9a's kernels-line entries."""
    t0 = time.perf_counter()
    entries = phase_fleet(dev)
    phase_sessions_cli(dev)
    phase_fleet_recovery(dev)
    print(f"[phase 9] wall {time.perf_counter() - t0:.1f} s")
    return list(entries)


# ---------------------------------------------------------------- phase 10

# Phase 10: the runtime over ranks (parallel/runtime.py), as subprocesses
# of this script on the one card: DIST_RANKS ranks over gloo (NCCL refuses
# two ranks on one GPU), each on cuda:0, laid out as DIST_RANKS hosts x 1
# chip.  Each rank waits on its own timeout.
DIST_RANKS = 2
RANK_TIMEOUT_S = 400
# 10a: (cost mode, kernel library, kernel) at phase 5b's width; each rank's
# kernel is held to its plain version on its first DIST_CHECK_ROWS rows.
DIST_MODES = (("rollout", "rollout", "K2"), ("rollout_local_turbo", "rollout_local", "K1 turbo"),
              ("fast_fused", "score", "K3"))
DIST_CHECK_ROWS = 4
# 10c: __graft_entry__.py:163-171's cadence: a merge within a host every 2
# iterations, across hosts every 4.
DIST_EXCHANGE = (2, 4)


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _in_turn(mesh, fn):
    """fn() run by each rank in turn while the others wait at a barrier
    (gloo: on the host), so that a rank times its kernels on a card no other
    rank uses.  Returns this rank's result."""
    import torch
    import torch.distributed as dist

    out = None
    for r in range(mesh.size):
        dist.barrier()
        if r == mesh.rank:
            out = fn()
            torch.cuda.synchronize()
    dist.barrier()
    return out


def _rank_world(x, dev):
    """The parent's batch world, on this rank's device."""
    from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot

    keys, guesses, devs, snaps, points, valid = x["batch_args"]
    snaps = MapSnapshot(*(t.to(dev) for t in snaps))
    return dict(x["batch"], args=(keys.to(dev), guesses.to(dev), devs.to(dev), snaps,
                                  points.to(dev), valid.to(dev)))


def _rank_solves(mesh, x):
    """10a on one rank: the hierarchy's sharded solver on the rank's rows
    in each mode, its launches, wall time and kernel against the plain
    version (first DIST_CHECK_ROWS rows, in the launch's cluster order;
    K3 over every row), timed in turn."""
    import torch
    import torch.distributed as dist

    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.ops import score as sc
    from ndtpso_slam_tpu_torch.parallel import runtime

    world = _rank_world(x, mesh.device)
    mine = dict(world, true=runtime.shard_rows(mesh, world["true"]),
                args=runtime.shard_rows(mesh, world["args"]))
    b = mine["true"].shape[0]
    cfg, mc = mine["pso_cfg"], mine["map_cfg"]
    out = {}
    for mode, kname, label in DIST_MODES:
        solver = runtime.make_hier_solver(mesh, mc, cfg, mode)
        solver(*mine["args"])  # warm: the first call also loads and queries
        dist.barrier()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = solver(*mine["args"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        want = _expected_launches(mode, cfg.iterations)
        check(all(counts[k] == want.get(k, 0) for k in counts),
              f"10a rank {mesh.rank} {mode}: launches {counts}, expected {want}")
        gathered = runtime.gather_global(mesh, tuple(res))
        if kname == "score":
            cluster = None
            ops = _score_inputs(mine, b)
            err = _check_score(ops, f"10a rank {mesh.rank}", f"B={b} N=384 P={cfg.population}")
            kern = lambda: sc.fused_bound_scores(*ops)
            plain = lambda: sc.fused_bound_scores_reference(*ops)
            bnd, plain_rows = _score_bound(ops), b
        else:
            local = kname == "rollout_local"
            lib = rl.pso_rollout_local if local else ro.pso_rollout
            cluster = lib.LAST_CLUSTER
            packed = _packed(mine, local)
            few = tuple(t[:DIST_CHECK_ROWS] for t in packed[:5]) + packed[5:]
            plain_fn = rl.pso_rollout_local_reference if local else ro.pso_rollout_reference
            kern = lambda: lib(*packed, rng_mode="native" if "turbo" in mode else "threefry")
            plain = lambda: plain_fn(*few, rng_mode="native" if "turbo" in mode else "threefry",
                                     cluster=cluster or 1)
            got = tuple(t[:DIST_CHECK_ROWS] for t in kern())
            tol = _TOLERANCES["rollout_local_turbo" if local else "rollout"]
            err = max(_compare(f"10a rank {mesh.rank} {label}", got, plain(), *tol))
            bound_of = _rollout_local_bound if local else _rollout_bound
            bnd = bound_of(packed[3], packed[4], cfg.population, [cfg.iterations] * b)
            plain_rows = DIST_CHECK_ROWS
        ms, plain_ms = _in_turn(mesh, lambda: (_events_ms(kern, 3), _events_ms(plain, 1)))
        print(f"[phase 10a] rank {mesh.rank}: {mode} on rows {mesh.rank * b}-{(mesh.rank + 1) * b - 1}"
              f" (B={b}): wall {wall:.3f} s with {mesh.size - 1} other rank(s) on the card; "
              f"launches {counts}; {label} vs plain ({plain_rows} rows, cluster {cluster}) max abs "
              f"err {err:.3e}; {label} {ms:.4f} ms alone on the card, plain {plain_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
        out[mode] = dict(pose=res.pose.cpu(), cost=res.cost.cpu(),
                         gathered=tuple(t.cpu() for t in gathered), counts=counts, wall=wall,
                         cluster=cluster, err=err, ms=ms, plain_ms=plain_ms, plain_rows=plain_rows,
                         bnd=bnd, launches=counts[kname])
    return out


def _reloc_cost(w):
    """7a's multi_swarm_solve cost: the matmul binder through K3."""
    from ndtpso_slam_tpu_torch.models import cost

    tbl = cost.snapshot_table(w["snap"])
    return lambda poses, binds: cost.bound_cost_fused(
        poses, cost.bind_points_matmul(binds, tbl, w["points"], w["valid"], w["map_cfg"]))


def _rank_swarms(mesh, x):
    """10c on one rank: its K / ranks swarms of 7a's workload through
    multi_swarm_solve (two-tier exchange) and multi_swarm_rollout (axis
    over every rank); then K2 on the rank's B = K / ranks inputs (7a's
    packing, checked to give the path's poses) against its plain version
    (first DIST_CHECK_ROWS rows, at the launch's cluster size), timed in
    turn."""
    from unittest import mock

    import torch

    from ndtpso_slam_tpu_torch.models import solve
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.parallel import multi_swarm as ms
    from ndtpso_slam_tpu_torch.parallel import runtime

    dev = mesh.device
    w = dict(x["reloc"], **{k: x["reloc"][k].to(dev) for k in ("points", "valid", "keys", "hypo")})
    w["snap"] = type(w["snap"])(*(t.to(dev) for t in (w["snap"].mean, w["snap"].inv_cov,
                                                      w["snap"].built)))
    keys, hypo = runtime.shard_rows(mesh, (w["keys"], w["hypo"]))
    cfg, mc = w["pso_cfg"], w["map_cfg"]
    out, solved = {}, []
    every, dcn_every = DIST_EXCHANGE

    def recording(*args):
        res = solve.solve_rollout_mode(*args)
        solved.append(res[0])
        return res
    for name, run in (
        ("solve", lambda: ms.multi_swarm_solve(
            keys, hypo, RELOC_DEV, _reloc_cost(w), cfg, exchange_every=every,
            axis_name=runtime.ICI_AXIS, dcn_axis_name=runtime.DCN_AXIS,
            dcn_exchange_every=dcn_every, mesh=mesh)),
        ("rollout", lambda: ms.multi_swarm_rollout(
            keys, hypo, RELOC_DEV, w["snap"], w["points"], w["valid"], cfg, mc,
            axis_name=runtime.SOLVE_AXES, mesh=mesh)),
    ):
        torch.cuda.synchronize()
        _reset_counts()
        with mock.patch.object(ms, "solve_rollout_mode", recording):
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _read_counts()
        want = {"score": cfg.iterations + 2} if name == "solve" else {"rollout": 1}
        check(counts == {n: want.get(n, 0) for n in counts},
              f"10c rank {mesh.rank} {name}: launches {counts}, expected {want}")
        out[name] = dict(pose=res.pose.cpu(), cost=res.cost.cpu(), wall=wall, counts=counts,
                         cluster=ro.pso_rollout.LAST_CLUSTER if name == "rollout" else None)
        print(f"[phase 10c] rank {mesh.rank}: multi_swarm_{name} over its {keys.shape[0]} "
              f"swarms: {wall:.3f} s; launches {counts}", flush=True)
    packed = _reloc_packed(dict(w, keys=keys, hypo=hypo))
    kern = lambda: ro.pso_rollout(*packed)
    got = kern()
    cluster = ro.pso_rollout.LAST_CLUSTER
    check(len(solved) == 1 and torch.equal(got[0], solved[0])
          and cluster == out["rollout"]["cluster"],
          f"10c rank {mesh.rank}: K2 on the packed inputs (C={cluster}) is not the path's launch "
          f"(C={out['rollout']['cluster']})")
    few = tuple(t[:DIST_CHECK_ROWS] for t in packed[:5]) + packed[5:]
    plain = lambda: ro.pso_rollout_reference(*few, cluster=cluster)
    err = max(_compare(f"10c rank {mesh.rank} K2", tuple(t[:DIST_CHECK_ROWS] for t in got), plain(),
                       *_TOLERANCES["rollout"]))
    k_ms, plain_ms = _in_turn(mesh, lambda: (_events_ms(kern, 3), _events_ms(plain, 1)))
    bnd = _rollout_bound(packed[3], packed[4], cfg.population, [cfg.iterations] * keys.shape[0])
    print(f"[phase 10c] rank {mesh.rank}: K2 at B={keys.shape[0]} (C={cluster}) on the path's "
          f"inputs vs plain ({DIST_CHECK_ROWS} rows) max abs err {err:.3e}; {k_ms:.4f} ms alone on "
          f"the card, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    out["k2"] = dict(launches=out["rollout"]["counts"]["rollout"], err=err, ms=k_ms,
                     plain_ms=plain_ms, bnd=bnd, cluster=cluster, batch=keys.shape[0])
    return out


def _merge_cfg():
    """10d's map: phase 4's scan.launch frame (300 m, 0.5 m cells, 100
    slots)."""
    from ndtpso_slam_tpu_torch import config as C

    return C.MapConfig(size_m=300.0, cell_side_m=0.5, window_slots=100)


# 10d: the per-cell fields compared with one process's ingestion, and the
# ring's, compared across ranks by checksum.
MERGE_CELL_FIELDS = ("mean_c", "inv_cov", "built", "created", "g_sum", "g_count", "g_cov",
                     "slot_idx", "rot_count", "cur_sum", "cur_count", "cur_m2")
MERGE_RING_FIELDS = ("slot_sum", "slot_count", "slot_cov")


def _checksum(t):
    """An int64 checksum of a tensor's bits (its 32-bit words, each times an
    odd weight of its position)."""
    import torch

    t = t.to(torch.int32) if t.dtype == torch.bool else t.contiguous()
    words = t.view(torch.int32).reshape(-1).to(torch.int64)
    weights = (torch.arange(words.numel(), device=t.device, dtype=torch.int64) * 2654435761) % (
        1 << 31) * 2 + 1
    return int((words * weights).sum())


def _rank_merge(mesh, x):
    """10d on one rank: phase 4's 50-scan log at its true poses, each rank
    ingesting its half of each scan, the deltas all-reduced, then the dense
    build; the time and bytes of each merge; every field's checksum
    gathered from every rank."""
    import torch

    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.parallel import distributed, runtime

    dev, mc = mesh.device, _merge_cfg()
    points, valid, poses = (x["log"][k].to(dev) for k in ("points", "valid", "poses"))
    state = ndt_map.init_map(mc, device=dev)
    merge_ms = []
    # As the one-process reference: each rank's index_add_ sums in one
    # order on every run, so the gap to the reference comes only from the
    # split of each scan over the ranks.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for t in range(points.shape[0]):
            p, v = runtime.shard_rows(mesh, (points[t], valid[t]))
            before = distributed.merged_fields(state)
            ndt_map.update(state, mc, poses[t], p, v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distributed.merge_deltas(before, state, mesh, runtime.SOLVE_AXES)
            torch.cuda.synchronize()
            merge_ms.append((time.perf_counter() - t0) * 1e3)
            ndt_map.build(state, mc)
    finally:
        torch.use_deterministic_algorithms(False)
    fields = MERGE_CELL_FIELDS + MERGE_RING_FIELDS
    sums = torch.tensor([_checksum(getattr(state, f)) for f in fields], device=dev)
    every = runtime.all_gather(mesh, sums, runtime.SOLVE_AXES).cpu()
    same = bool((every == every[0]).all())
    check(same, f"10d rank {mesh.rank}: the ranks' maps differ: checksums {every.tolist()}")
    nbytes = 28.0 * (mc.num_cells + 1)  # [C+1, 5] float32 and [C+1, 2] int32 per merge
    print(f"[phase 10d] rank {mesh.rank}: {len(merge_ms)} merges of {nbytes / 1e6:.3f} MB each "
          f"(all-reduce, {mesh.size} ranks): median {np.median(merge_ms):.3f} ms, max "
          f"{max(merge_ms):.3f} ms; every field's checksum equal on all {mesh.size} ranks",
          flush=True)
    out = dict(merge_ms=merge_ms, nbytes=nbytes, checksums=sums.cpu())
    if mesh.rank == 0:
        out["fields"] = {f: getattr(state, f).cpu() for f in MERGE_CELL_FIELDS}
    return out


def _rank_fleet(mesh):
    """10e on one rank: its robots of 9a's fleet through
    run_offline_fleet_sharded under deterministic algorithms, the launches,
    phase 4's gate per robot, then K1 at B = its robots on the last solve
    and E4 on the next step's ids against their plain versions, timed in
    turn."""
    import torch

    from ndtpso_slam_tpu_torch.models import slam
    from ndtpso_slam_tpu_torch.models.scan import Scan
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.parallel import fleet, runtime

    cfg, dev = _fleet_cfg(), mesh.device
    w = fleet_world(dev)
    robots = runtime.shard_rows(mesh, np.arange(FLEET_B))
    w = dict(w, logs=[w["logs"][r] for r in robots], init=w["init"][robots], keys=w["keys"][robots],
             scans=Scan(points=w["scans"].points[robots], valid=w["scans"].valid[robots]))
    b, t = w["scans"].valid.shape[:2]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with _solves_logged(rl.pso_rollout_local) as log:
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            states = slam.init_slam_batch(cfg, w["init"], dev)
            states, poses, costs = fleet.run_offline_fleet_sharded(mesh, states, w["scans"],
                                                                   w["keys"], cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _read_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    want = {n: {"rollout_local": t - 1, "row_scatter": 2 * t}.get(n, 0) for n in counts}
    check(counts == want, f"10e rank {mesh.rank}: launches {counts}, expected {want}")
    mine = poses[robots].cpu().numpy()
    gt = np.stack([lg.poses for lg in w["logs"]])
    err = np.hypot(mine[..., 0] - gt[..., 0], mine[..., 1] - gt[..., 1])
    check((err.mean(axis=1) < GATE_MEAN_M).all() and (err.max(axis=1) < GATE_MAX_M).all(),
          f"10e rank {mesh.rank}: per-robot gate: mean {err.mean(axis=1)}, max {err.max(axis=1)}")
    _, keys, guesses, devs, snaps, points, valid, mc, pso_cfg, _ = log["args"]
    sten, pts = _pack_local(snaps, mc, guesses, points, valid)
    k1 = (keys, guesses, devs, sten, pts, pso_cfg, mc)
    dpose, dcost = compare_kernel(*k1)
    cluster = rl.pso_rollout_local.LAST_CLUSTER
    ms, plain_ms = _in_turn(mesh, lambda: (
        _events_ms(lambda: rl.pso_rollout_local(*k1), 50),
        _events_ms(lambda: rl.pso_rollout_local_reference(*k1), 2)))
    bnd = _rollout_local_bound(sten, pts, pso_cfg.population, [pso_cfg.iterations] * b)
    scatter = _in_turn(mesh, lambda: _fleet_scatter(w, cfg, states))
    print(f"[phase 10e] rank {mesh.rank}: robots {robots.tolist()} x {t} scans: wall {wall:.3f} s "
          f"({b * t / wall:.2f} scans/s beside {mesh.size - 1} other rank(s)); per-robot mean err "
          f"{err.mean(axis=1).round(4).tolist()} m, max {err.max(axis=1).round(4).tolist()} m; "
          f"launches {counts}; K1 at B={b} (C={cluster}) vs plain max |dpose| {dpose:.3e} |dcost| "
          f"{dcost:.3e}, {ms:.4f} ms alone on the card, plain {plain_ms:.3f} ms, bound "
          f"{bnd[0]:.6f} ms ({bnd[1]})", flush=True)
    return dict(poses=poses.cpu(), costs=costs.cpu(), counts=counts, wall=wall,
                clusters=sorted(set(log["cs"])), k1=dict(err=max(dpose, dcost), ms=ms,
                                                          plain_ms=plain_ms, bnd=bnd,
                                                          cluster=cluster, batch=b),
                scatter=scatter)


def rank_main(tmp, device="cuda") -> int:
    """One rank of phase 10 (``chip_smoke.py --rank DIR``, NDTPSO_* set by
    the parent): 10a, 10c, 10d and 10e on the rank's share, written to
    DIR/rank{r}.pt."""
    import torch
    import torch.distributed as dist

    from ndtpso_slam_tpu_torch.parallel import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(runtime.initialize_distributed(backend="gloo", device=device), "rank: NDTPSO_* not set")
    mesh = runtime.make_hier_mesh(DIST_RANKS, 1, device)
    want = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    check(mesh.device == want, f"rank {mesh.rank} on {mesh.device}, expected {want}")
    x = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    out = dict(solves=_rank_solves(mesh, x), swarms=_rank_swarms(mesh, x),
               merge=_rank_merge(mesh, x), fleet=_rank_fleet(mesh))
    out["routes"] = dict(mesh.routes)
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"[phase 10] rank {mesh.rank} done", flush=True)
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(tmp):
    """The DIST_RANKS ranks, each this script with ``--rank``; each waits on
    its own timeout, and a rank that fails or times out fails the phase
    (the others are stopped).  Returns the ranks' results, rank order."""
    import torch

    port = _free_port()
    procs = []
    for r in range(DIST_RANKS):
        env = dict(os.environ, NDTPSO_COORDINATOR=f"localhost:{port}",
                   NDTPSO_NUM_PROCESSES=str(DIST_RANKS), NDTPSO_PROCESS_ID=str(r),
                   PYTHONPATH=HERE)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", tmp],
                                      cwd=HERE, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"chip_smoke: 10: rank {r} timed out after {RANK_TIMEOUT_S} s")
            lines = [ln for ln in text.splitlines() if ln.startswith("[phase 10")]
            print("\n".join(lines), flush=True)
            check(p.returncode == 0, f"10: rank {r} exited {p.returncode}:\n{text[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(DIST_RANKS)]


def _emulated_two_tier(w, hosts, per_rank):
    """10c's reference: all K swarms in this process, with the two-tier
    merges of a hosts x 1 mesh written out (within a rank's swarms every
    DIST_EXCHANGE[0] iterations, over all of them every DIST_EXCHANGE[1],
    and at the end)."""
    import torch

    from ndtpso_slam_tpu_torch.models import pso

    every, dcn_every = DIST_EXCHANGE
    k = w["hypo"].shape[0]

    def merge(gbest, cost, groups):
        pose, best = gbest.clone(), cost.clone()
        for ranks in groups:
            rows = [pso._select_min(cost[r * per_rank:(r + 1) * per_rank],
                                    gbest[r * per_rank:(r + 1) * per_rank]) for r in ranks]
            c, p = pso._select_min(torch.stack([c for c, _ in rows]),
                                   torch.stack([p for _, p in rows]))
            for r in ranks:
                pose[r * per_rank:(r + 1) * per_rank], best[r * per_rank:(r + 1) * per_rank] = p, c
        return pose, best

    hosts_groups = [[h] for h in range(hosts)]
    everything = [list(range(hosts))]
    exchange = lambda i, gbest, cost: (
        merge(gbest, cost, everything) if (i + 1) % dcn_every == 0 else
        merge(gbest, cost, hosts_groups) if (i + 1) % every == 0 else None)
    devs = w["hypo"].new_tensor(RELOC_DEV).expand(k, 3)
    res = pso.pso_solve_batch(w["keys"], w["hypo"], devs, _reloc_cost(w), w["pso_cfg"],
                              exchange=exchange)
    pose, cost = merge(res.pose, res.cost, everything)
    return pose[0], cost[0]


def _held(name, got, ref, c_rank, c_ref, tol, log):
    """Bit for bit where the kernel ran at one cluster size both ways, else
    within ``tol`` with the reason printed.  Returns max |d|."""
    import torch

    (gp, gc), (rp, rc) = got, ref
    d = max(float((gp - rp).abs().max()), float((gc - rc).abs().max()))
    if c_rank == c_ref:
        check(torch.equal(gp, rp) and torch.equal(gc, rc),
              f"{name}: differs from one process at equal cluster size {c_ref}: {d:.3e}")
    else:
        _compare(name, (gp, gc), (rp, rc), *tol)
        log.append(f"{name}: the ranks launched at C {c_rank}, one process at C {c_ref}: summed "
                   f"in other orders, held to {tol} (max |d| {d:.3e})")
    return d


def phase_distributed(world, lg, k_ms, dev=None):
    """Phase 10: the sharded solver, the hosts x chips runtime, the exact
    map merge, the cross-rank exchange and the sharded fleet, as
    DIST_RANKS ranks of this script on the card, each result held to this
    process's unsharded run; then 10b, the sharded solver at world 1 over
    NCCL in this process.  ``k_ms`` is phase 5's {kernel name: ms}.  Returns
    the kernels-line entries of the ranks' kernels."""
    import torch
    import torch.distributed as dist

    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.models import slam
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.parallel import fleet, mesh, multi_swarm, runtime

    t_phase = time.perf_counter()
    smi, cpu = _smi(), lambda t: t.cpu()
    dev = dev or torch.device("cuda")
    keys, guesses, devs, snaps, points, valid = world["args"]
    reloc = reloc_world(dev)
    mc = _merge_cfg()
    scans = [scan_mod.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max,
                                 _fleet_cfg().scan, mc, device=dev) for r in lg.ranges]
    log_x = dict(points=torch.stack([s.points for s in scans]).cpu(),
                 valid=torch.stack([s.valid for s in scans]).cpu(),
                 poses=torch.from_numpy(lg.poses.astype(np.float32)))
    x = dict(batch={k: world[k] for k in ("map_cfg", "pso_cfg", "true")},
             batch_args=(cpu(keys), cpu(guesses), cpu(devs), tuple(map(cpu, (
                 snaps.mean, snaps.inv_cov, snaps.built))), cpu(points), cpu(valid)),
             reloc=dict(reloc, **{k: cpu(reloc[k]) for k in ("points", "valid", "keys", "hypo")},
                        snap=ndt_map.MapSnapshot(*map(cpu, (reloc["snap"].mean,
                                                            reloc["snap"].inv_cov,
                                                            reloc["snap"].built)))),
             log=log_x)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        torch.save(x, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        ranks = _spawn_ranks(tmp)
        ranks_s = time.perf_counter() - t0
    notes = []

    # 10a: each rank's rows against one process's solve_batch.
    b = keys.shape[0]
    per = b // DIST_RANKS
    refs = {}
    for mode, kname, label in DIST_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = mesh.solve_batch(*world["args"], world["map_cfg"], world["pso_cfg"], mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c_ref = None if kname == "score" else _launch_counts()[kname].LAST_CLUSTER
        refs[mode] = ref
        worst = 0.0
        tol = _TOLERANCES["rollout_local_turbo" if kname == "rollout_local" else "rollout"]
        for r, out in enumerate(ranks):
            o = out["solves"][mode]
            rows = slice(r * per, (r + 1) * per)
            worst = max(worst, _held(f"10a {mode} rank {r}", (o["pose"], o["cost"]),
                                     (ref.pose[rows].cpu(), ref.cost[rows].cpu()), o["cluster"],
                                     c_ref, tol, notes))
            check(all(torch.equal(a, c) for a, c in zip(o["gathered"], ranks[0]["solves"][mode]["gathered"])),
                  f"10a {mode}: rank {r} gathered another batch than rank 0")
        gp, gc = ranks[0]["solves"][mode]["gathered"]
        check(torch.equal(gp, torch.cat([o["solves"][mode]["pose"] for o in ranks])),
              f"10a {mode}: the gathered rows are not the ranks' rows in rank order")
        err = np.abs(gp.numpy() - world["true"])
        check(np.median(err[:, :2]) < GATE_MEDIAN_XY_M and np.median(err[:, 2]) < GATE_MEDIAN_TH_RAD,
              f"10a {mode}: accuracy gate {np.median(err[:, :2]):.4f} m {np.median(err[:, 2]):.5f} rad")
        walls = [o["solves"][mode]["wall"] for o in ranks]
        kms = [o["solves"][mode]["ms"] for o in ranks]
        print(f"[phase 10a] sharded {mode}, B={b} as {DIST_RANKS} x {per} over gloo ({smi}): "
              f"gathered rows vs one process's solve_batch max |d| {worst:.3e} "
              f"({'bit-equal' if worst == 0 else 'see below'}); median xy "
              f"{np.median(err[:, :2]):.4f} m; per-rank wall of a warm call "
              f"{[round(v, 3) for v in walls]} s against {wall:.3f} s in one process; {label} per rank "
              f"{[round(v, 4) for v in kms]} ms (B={per}, each alone on the card) beside phase "
              f"{'5c' if kname == 'rollout_local' else '5b'}'s "
              f"{k_ms[{'fast_fused': 'score'}.get(mode, mode)]:.4f} ms at "
              f"B={BATCH_SMALL if kname == 'rollout_local' else b}")

    # 10b: world 1 over NCCL in this process.
    runtime.initialize_distributed(f"localhost:{_free_port()}", 1, 0, device=dev)
    try:
        one = mesh.make_mesh(device=dev)
        check(dist.get_backend() == ("nccl" if dev.type == "cuda" else "gloo"),
              f"10b: backend {dist.get_backend()}")
        for mode, kname, _ in DIST_MODES:
            _reset_counts()
            res = mesh.solve_batch_sharded(one, *world["args"], world["map_cfg"], world["pso_cfg"],
                                           mode)
            torch.cuda.synchronize()
            counts = _read_counts()
            check(counts[kname] == _expected_launches(mode, world["pso_cfg"].iterations)[kname],
                  f"10b {mode}: launches {counts}")
            check(torch.equal(res.pose, refs[mode].pose) and torch.equal(res.cost, refs[mode].cost),
                  f"10b {mode}: the NCCL world-1 solve differs from solve_batch")
        print(f"[phase 10b] world 1 over {dist.get_backend()}: solve_batch_sharded in {', '.join(m for m, _, _ in DIST_MODES)}"
              f" at B={b} bit-equal to solve_batch; collectives {dict(one.routes)}")
    finally:
        dist.destroy_process_group()

    # 10c: the exchange against all K swarms in one process at the cadence.
    k = reloc["hypo"].shape[0]
    pose, cost = _emulated_two_tier(reloc, DIST_RANKS, k // DIST_RANKS)
    for r, out in enumerate(ranks):
        o = out["swarms"]["solve"]
        check(torch.equal(o["pose"], pose.cpu()) and torch.equal(o["cost"], cost.cpu()),
              f"10c rank {r}: multi_swarm_solve differs from the one-process two-tier run: "
              f"{o['pose'].tolist()} vs {pose.tolist()}")
    _reloc_gate("10c multi_swarm_solve", ranks[0]["swarms"]["solve"]["pose"], reloc["true"])
    full = multi_swarm.multi_swarm_rollout(reloc["keys"], reloc["hypo"], RELOC_DEV, reloc["snap"],
                                           reloc["points"], reloc["valid"], reloc["pso_cfg"],
                                           reloc["map_cfg"])
    c_full = ro.pso_rollout.LAST_CLUSTER
    d_roll = max(_held(f"10c multi_swarm_rollout rank {r}", (o["swarms"]["rollout"]["pose"],
                                                              o["swarms"]["rollout"]["cost"]),
                       (full.pose.cpu(), full.cost.cpu()), o["swarms"]["rollout"]["cluster"],
                       c_full, _TOLERANCES["rollout"], notes) for r, o in enumerate(ranks))
    _reloc_gate("10c multi_swarm_rollout", ranks[0]["swarms"]["rollout"]["pose"], reloc["true"])
    print(f"[phase 10c] {DIST_RANKS} hosts x 1 chip, K={k} ({k // DIST_RANKS} per rank), P="
          f"{reloc['pso_cfg'].population}, I={reloc['pso_cfg'].iterations} ({smi}): "
          f"multi_swarm_solve (K3, merge within a rank every {DIST_EXCHANGE[0]}, across ranks every "
          f"{DIST_EXCHANGE[1]}) bit-equal on every rank to the one-process run at that cadence; "
          f"multi_swarm_rollout (K2, the exact winners gathered over ranks) vs the one-process K={k} "
          f"call max |d| {d_roll:.3e}; rank walls "
          f"{[round(o['swarms'][n]['wall'], 3) for o in ranks for n in ('solve', 'rollout')]} s")

    # 10d: the merged map against one process ingesting every point.
    st = ndt_map.init_map(mc, device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for t in range(len(scans)):
            ndt_map.update(st, mc, log_x["poses"][t].to(dev), scans[t].points, scans[t].valid)
            ndt_map.build(st, mc)
    finally:
        torch.use_deterministic_algorithms(False)
    got = ranks[0]["merge"]["fields"]
    diffs = {}
    for f in MERGE_CELL_FIELDS:  # the real cells; row C is the spare row of dropped points
        a, c = got[f][:mc.num_cells], getattr(st, f)[:mc.num_cells].cpu()
        if a.dtype in (torch.bool, torch.int32):
            check(torch.equal(a, c), f"10d: {f} differs from one process's ingestion")
        else:
            diffs[f] = float((a - c).abs().max())
    check(diffs["cur_sum"] <= 1e-4 and diffs["g_sum"] <= 1e-5,
          f"10d: cur_sum {diffs['cur_sum']:.3e} (1e-4), g_sum {diffs['g_sum']:.3e} (1e-5)")
    ring_ref = {f: _checksum(getattr(st, f)) for f in MERGE_RING_FIELDS}
    ring_got = dict(zip(MERGE_CELL_FIELDS + MERGE_RING_FIELDS,
                        ranks[0]["merge"]["checksums"].tolist()))
    check(ring_got["slot_count"] == ring_ref["slot_count"], "10d: slot_count differs")
    ms_all = np.array([o["merge"]["merge_ms"] for o in ranks])
    del st
    print(f"[phase 10d] exact map merge, {mc.size_m:.0f} m / {mc.cell_side_m} m / "
          f"{mc.window_slots} slots, {len(scans)} scans at their "
          f"true poses, {DIST_RANKS} ranks each ingesting half of each scan ({smi}): integer "
          f"fields, flags and slot counts bit-equal to one process ingesting everything; max |d| "
          f"{ {f: float(f'{v:.3e}') for f, v in diffs.items()} } (cur_sum within 1e-4, g_sum "
          f"within 1e-5); every rank's fields bit-equal (checksums); {ranks[0]['merge']['nbytes'] / 1e6:.3f}"
          f" MB per merge and rank, merge time per scan (ms) rank 0 "
          f"{np.round(ms_all[0], 2).tolist()}; median {np.median(ms_all):.3f} ms, max "
          f"{ms_all.max():.3f} ms over both ranks")

    # 10e: the sharded fleet against the unsharded one.
    cfg = _fleet_cfg()
    w = fleet_world(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with _solves_logged(rl.pso_rollout_local) as log:
            states = slam.init_slam_batch(cfg, w["init"], dev)
            _, fposes, fcosts = fleet.run_offline_fleet(states, w["scans"], w["keys"], cfg)
            del states
    finally:
        torch.use_deterministic_algorithms(False)
    c_ref = sorted(set(log["cs"]))
    gp = ranks[0]["fleet"]["poses"]
    per_f = FLEET_B // DIST_RANKS
    equal = 0
    for r, out in enumerate(ranks):
        check(torch.equal(out["fleet"]["poses"], gp), f"10e: rank {r} gathered other poses")
        rows = slice(r * per_f, (r + 1) * per_f)
        d = _held(f"10e robots {rows.start}-{rows.stop - 1}", (gp[rows], ranks[0]["fleet"]["costs"][rows]),
                  (fposes[rows].cpu(), fcosts[rows].cpu()), out["fleet"]["clusters"], c_ref,
                  (0.0, TRAJ_ATOL, TRAJ_ATOL), notes)
        equal += per_f * (d == 0)
    walls = [o["fleet"]["wall"] for o in ranks]
    print(f"[phase 10e] 9a's fleet of {FLEET_B} robots through run_offline_fleet_sharded, "
          f"{per_f} per rank ({smi}): {equal} of {FLEET_B} robots bit-equal to the unsharded "
          f"fleet (deterministic algorithms; C {ranks[0]['fleet']['clusters']} per rank, {c_ref} "
          f"unsharded); rank walls {[round(v, 3) for v in walls]} s, "
          f"{FLEET_B * FLEET_SCANS / max(walls):.2f} scans/s aggregate over the ranks (one card, "
          f"time-sliced: overhead, not scaling)")
    for line in notes:
        print(f"[phase 10] {line}")
    routes = {f"{op} {backend} {route}": n for (op, backend, route), n in
              ranks[0]["routes"].items()}
    print(f"[phase 10] collectives of rank 0 (op, backend, tensors' device: calls): {routes}; "
          f"ranks {ranks_s:.1f} s from spawn to results; phase 10 wall "
          f"{time.perf_counter() - t_phase:.1f} s")

    o, f0 = ranks[0]["solves"], ranks[0]["fleet"]
    entries = []
    for mode, kname, _ in DIST_MODES:
        e = o[mode]
        source = {"rollout": "rollout.cu", "rollout_local": "rollout_local.cu", "score": "score.cu"}
        replaces = {"rollout": "pallas_rollout.py:111", "rollout_local": "pallas_rollout.py:618",
                    "score": "pallas_score.py:41"}
        extra = {} if kname == "score" else dict(cluster=e["cluster"])
        entries.append(_entry(f"{'score' if kname == 'score' else mode}_rank", SRC + source[kname],
                              "ndtpso_slam_tpu/ops/" + replaces[kname], e["launches"], e["err"],
                              e["ms"], e["plain_ms"], e["bnd"], batch=per, ranks=DIST_RANKS,
                              plain_rows=e["plain_rows"], **extra))
    k2 = ranks[0]["swarms"]["k2"]
    entries.append(_entry("rollout_multiswarm_rank", SRC + "rollout.cu",
                          "ndtpso_slam_tpu/ops/pallas_rollout.py:111", k2["launches"], k2["err"],
                          k2["ms"], k2["plain_ms"], k2["bnd"], cluster=k2["cluster"],
                          batch=k2["batch"], ranks=DIST_RANKS, plain_rows=DIST_CHECK_ROWS))
    k1 = f0["k1"]
    entries.append(_entry("rollout_local_fleet_rank", SRC + "rollout_local.cu",
                          "ndtpso_slam_tpu/ops/pallas_rollout.py:551", f0["counts"]["rollout_local"],
                          k1["err"], k1["ms"], k1["plain_ms"], k1["bnd"], cluster=k1["cluster"],
                          batch=k1["batch"], ranks=DIST_RANKS))
    kt, it, s_plain, s_bnd = f0["scatter"]
    entries.append(_entry("row_scatter_fleet_rank", SRC + "row_scatter.cu",
                          "experiments/scatter_unique_ab.py:63", f0["counts"]["row_scatter"], 0.0,
                          kt["ms"], s_plain, s_bnd, calls_per_step=2, device_ms=kt["device_ms"],
                          host_us=kt["host_us"], ranks=DIST_RANKS, indexed_assignment=it))
    return entries


# ---------------------------------------------------------------- phase 11

GOLDEN_B = 64
GOLDEN_BEAMS = 360
GOLDEN_DEV = (0.4, 0.4, 0.08)
GOLDEN_GATE = 1e-3  # BASELINE.json: pose RMSE <= 1e-3 m / 1e-3 rad
GOLDEN_SLAM_KEY = (9, 17)
GOLDEN_THREADS = 8  # host threads running the golden's solves


def _golden_map_cfg():
    from ndtpso_slam_tpu_torch import config as C

    return C.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=8, slot_capacity=50)


def golden_world(dev, b=GOLDEN_B):
    """tests/test_parity_golden.py's config-1 recipe (_world_scans,
    _build_both) for seeds 0 .. b-1: the port's maps built on ``dev``, the
    golden's from the same jittered float64 points, the query scans loaded
    by the port.  Returns the solve_batch arguments, the PSO configuration
    and the golden maps."""
    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.utils import native

    mc, sc = _golden_map_cfg(), C.ScanConfig(max_beams=384)
    step = 2 * np.pi / GOLDEN_BEAMS
    load = lambda r: scan_mod.load_laser(r.astype(np.float32), -np.pi, step, 30.0, sc, mc,
                                         device=dev)
    snaps, queries, golds = [], [], []
    for seed in range(b):
        rs = np.random.RandomState(seed)
        segs = synthetic.make_world(seed=seed, size=50.0, n_boxes=8)
        ref = load(synthetic.raycast(segs, np.zeros(3), GOLDEN_BEAMS, -np.pi, step, 30.0))
        true = rs.uniform([-0.25, -0.25, -0.04], [0.25, 0.25, 0.04])
        queries.append(load(synthetic.raycast(segs, true, GOLDEN_BEAMS, -np.pi, step, 30.0)))
        jitter = np.random.RandomState(seed + 10)
        state = ndt_map.init_map(mc, device=dev)
        gold = native.GoldenMap(mc.size_m, mc.cell_side_m, mc.window_slots, mc.slot_capacity)
        pts0 = ref.points.cpu().numpy().astype(np.float64)
        valid = ref.valid.cpu().numpy()
        for _ in range(3):
            pts = pts0 + jitter.normal(0, 0.03, pts0.shape)
            ndt_map.add_points(state, mc, torch.from_numpy(pts.astype(np.float32)).to(dev),
                               ref.valid)
            ndt_map.build(state, mc)
            gold.update(np.zeros(3), pts, valid)
            gold.build()
        snaps.append(ndt_map.snapshot(state, mc))
        golds.append(gold)
    stack = lambda f: torch.stack([getattr(s, f) for s in snaps])
    args = (torch.tensor([[s, s + 100] for s in range(b)], dtype=torch.int64, device=dev),
            torch.zeros(b, 3, device=dev), torch.tensor([GOLDEN_DEV] * b, device=dev),
            ndt_map.MapSnapshot(mean=stack("mean"), inv_cov=stack("inv_cov"),
                                built=stack("built")),
            torch.stack([q.points for q in queries]), torch.stack([q.valid for q in queries]),
            mc)
    return args, C.PSOConfig(iterations=50, population=50), golds


def _golden_poses(args, pso, golds):
    """The golden's solve of each of the batch's scans, on host threads."""
    from concurrent.futures import ThreadPoolExecutor

    points = args[4].cpu().numpy().astype(np.float64)
    valid = args[5].cpu().numpy()

    def solve(s):
        pose, _ = golds[s].pso(points[s], np.zeros(3), GOLDEN_DEV, (s, s + 100),
                               iterations=pso.iterations, population=pso.population,
                               valid=valid[s])
        return pose

    with ThreadPoolExecutor(GOLDEN_THREADS) as pool:
        return np.stack(list(pool.map(solve, range(len(golds)))))


def _golden_rmse(poses, gold):
    """(xy RMSE, theta RMSE, max |dpose|, solves off by more than the gate)
    of poses [B, 3] against the golden's."""
    d = poses.cpu().numpy().astype(np.float64) - gold
    return (float(np.sqrt(np.mean(d[:, :2] ** 2))), float(np.sqrt(np.mean(d[:, 2] ** 2))),
            float(np.abs(d).max()), int((np.abs(d).max(1) > GOLDEN_GATE).sum()))


def _golden_gate(tag, poses, gold):
    """Pose RMSE (xy, theta) against the golden, held to the gate."""
    rmse_xy, rmse_th, worst, off = _golden_rmse(poses, gold)
    check(np.isfinite(worst) and rmse_xy <= GOLDEN_GATE and rmse_th <= GOLDEN_GATE,
          f"{tag}: RMSE against the golden {rmse_xy:.3e} m / {rmse_th:.3e} rad (gate "
          f"{GOLDEN_GATE})")
    print(f"[phase 11a] {tag} vs golden over {len(gold)} solves: RMSE {rmse_xy:.3e} m / "
          f"{rmse_th:.3e} rad (gate {GOLDEN_GATE}), max |dpose| {worst:.3e}, {off} solves off "
          f"by more than {GOLDEN_GATE}")


def _k1_vs_plain(tag, kargs, radius, got):
    """K1 on kargs gives ``got`` (the gated launch's poses) again and agrees
    with its plain version summed in the order of the cluster it ran on.
    Returns (max |dpose|, max |dcost|, the cluster size, the plain
    version's ms)."""
    import torch

    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    from ndtpso_slam_tpu_torch.experiments import time_ms

    kp, kc = rl.pso_rollout_local(*kargs, radius=radius)
    torch.cuda.synchronize()
    ran_on = rl.pso_rollout_local.LAST_CLUSTER
    out = []
    plain_ms = time_ms(lambda: out.append(rl.pso_rollout_local_reference(
        *kargs, radius=radius, cluster=ran_on)), 1, torch.device("cuda"), warm=False)
    rp, rc = out[0]
    dpose = (kp - rp).abs().max().item()
    dcost = (kc - rc).abs().max().item()
    check(torch.equal(kp, got.to(kp.dtype)), f"11a: {tag} differs from the gated launch")
    check(torch.allclose(kc, rc, rtol=COST_RTOL, atol=COST_ATOL) and dpose <= POSE_ATOL,
          f"11a: {tag} vs plain: max |dpose| {dpose:.3e}, max |dcost| {dcost:.3e}")
    return dpose, dcost, ran_on, plain_ms


def _golden_log_run(dtype, cost_mode, dev):
    """tests/test_parity_golden.py:_slam_vs_golden on ``dev``: run_offline
    over the 12-scan log, golden_slam_run on the same loaded points.
    Returns (port poses, golden poses, the log's true poses, K1 launches)."""
    import torch

    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.io import synthetic
    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.models import slam
    from ndtpso_slam_tpu_torch.utils import native

    mc = _golden_map_cfg()
    cfg = C.SlamConfig(pso=C.PSOConfig(iterations=30, population=50), map=mc,
                       scan=C.ScanConfig(max_beams=384), og=C.OccupancyGridConfig(enabled=False),
                       cost_mode=cost_mode, dtype=dtype)
    lg = synthetic.make_log(seed=6, n_scans=12, n_beams=GOLDEN_BEAMS, world_size=40.0)
    loaded = [scan_mod.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max, cfg.scan,
                                  mc, dtype=dtype, device=dev) for r in lg.ranges]
    scans = scan_mod.Scan(points=torch.stack([s.points for s in loaded]),
                          valid=torch.stack([s.valid for s in loaded]))
    state = slam.init_slam(cfg, tuple(lg.poses[0]), device=dev)
    torch.cuda.synchronize()
    _reset_counts()
    _, poses, _ = slam.run_offline(state, scans, GOLDEN_SLAM_KEY, cfg)
    torch.cuda.synchronize()
    counts = _read_counts()
    gold = native.golden_slam_run(
        scans.points.cpu().numpy().astype(np.float64), scans.valid.cpu().numpy(), lg.poses[0],
        mc.size_m, mc.cell_side_m, mc.window_slots, mc.slot_capacity, GOLDEN_SLAM_KEY,
        iterations=30, population=50)
    poses = poses.cpu().numpy().astype(np.float64)
    check(np.isfinite(poses).all() and poses.shape == (12, 3),
          f"golden log {cost_mode} {dtype}: poses not finite [12, 3]")
    return poses, gold, lg.poses, counts


def _accuracy(tag, poses, gold, truth):
    """tests/test_parity_golden.py:test_slam_trajectory_accuracy_parity_f32's
    condition: the port tracks the ground truth as well as the golden."""
    err = lambda p: float(np.sqrt(np.mean((p[:, :2] - truth[:, :2]) ** 2)))
    eng, ref = err(poses), err(gold)
    check(eng < 1.5 * ref + 1e-3, f"{tag}: RMSE to the ground truth {eng:.5f} m against the "
          f"golden's {ref:.5f} m (limit 1.5 x + 1e-3)")
    return eng, ref


def phase_golden(dev):
    """11: the port's exact-cost routes against the C++ golden reference."""
    import torch

    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.parallel import mesh
    from ndtpso_slam_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.golden()  # built here, at first use
    build_s = time.perf_counter() - t0
    args, pso, golds = golden_world(dev)
    t1 = time.perf_counter()
    gold = _golden_poses(args, pso, golds)
    golden_s = time.perf_counter() - t1
    # K1 as the main path runs it: solve_batch in rollout_local, the 25-cell
    # stencil (radius 2) gathered at the guess.  A point that a particle
    # moves more than 2 cells from its anchor cell scores 0 there, where the
    # golden's exact cost scores it: on this workload the two functions part
    # on 4 of the 64 seeds, in both packages (ROADMAP §3, R9), so this
    # launch's RMSE is reported beside its plain version, not gated.
    torch.cuda.synchronize()
    _reset_counts()
    k1 = mesh.solve_batch(*args, pso, cost_mode="rollout_local")
    torch.cuda.synchronize()
    counts = _read_counts()
    want = {n: int(n == "rollout_local") for n in counts}
    check(counts == want, f"11a: rollout_local at B={GOLDEN_B} launched {counts}, expected {want}")
    rmse_xy, rmse_th, worst, off = _golden_rmse(k1.pose, gold)
    keys, guesses, devs, snaps, points, valid, mc = args
    kargs = (keys, guesses, devs, *_pack_local(snaps, mc, guesses, points, valid), pso, mc)
    dpose, dcost, cluster, plain_ms = _k1_vs_plain("K1 (radius 2)", kargs, 2, k1.pose)
    ms = _events_ms(lambda: rl.pso_rollout_local(*kargs), 20)
    sten, pts = kargs[3], kargs[4]
    bnd = _rollout_local_bound(sten, pts, pso.population, [pso.iterations] * GOLDEN_B)
    print(f"[phase 11a] solve_batch rollout_local (K1, radius 2: 25 cells; B={GOLDEN_B} N="
          f"{pts.shape[1]} P={pso.population} I={pso.iterations}, 1 launch, cluster of {cluster})"
          f" vs golden: RMSE {rmse_xy:.3e} m / {rmse_th:.3e} rad, max |dpose| {worst:.3e}, "
          f"{off} solves off by more than {GOLDEN_GATE} (reported: the stencil's function); "
          f"K1 vs plain max |dpose| {dpose:.3e} max |dcost| {dcost:.3e}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}, "
          f"{100 * bnd[0] / ms:.2f}% of it)")

    # The same kernel with a stencil of 81 cells (radius 4), which holds every
    # particle's points on this workload: the exact cost, held to the gate.
    kargs4 = (keys, guesses, devs, *_pack_local(snaps, mc, guesses, points, valid, radius=4),
              pso, mc)
    torch.cuda.synchronize()
    _reset_counts()
    k1_wide, _ = rl.pso_rollout_local(*kargs4, radius=4)
    torch.cuda.synchronize()
    counts = _read_counts()
    check(counts == want, f"11a: K1 at radius 4 launched {counts}, expected {want}")
    dpose4, dcost4, cluster4, plain4_ms = _k1_vs_plain("K1 (radius 4)", kargs4, 4, k1_wide)
    ms4 = _events_ms(lambda: rl.pso_rollout_local(*kargs4, radius=4), 20)
    bnd4 = _rollout_local_bound(kargs4[3], kargs4[4], pso.population, [pso.iterations] * GOLDEN_B)
    _golden_gate(f"K1, radius 4: 81 cells (B={GOLDEN_B}, 1 launch, cluster of {cluster4}; vs "
                 f"plain max |dpose| {dpose4:.3e} max |dcost| {dcost4:.3e}; kernel {ms4:.4f} ms, "
                 f"plain {plain4_ms:.3f} ms, bound {bnd4[0]:.6f} ms ({bnd4[1]}, "
                 f"{100 * bnd4[0] / ms4:.2f}% of it))", k1_wide, gold)

    _reset_counts()
    t2 = time.perf_counter()
    plain = mesh.solve_batch(*args, pso, cost_mode="exact")
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t2
    check(not any(_read_counts().values()), "11a: the exact route launched a kernel")
    _golden_gate(f"solve_batch exact (plain PyTorch, B={GOLDEN_B}, {exact_s:.2f} s)",
                 plain.pose, gold)
    print(f"[phase 11a] golden {golden_s:.2f} s on {GOLDEN_THREADS} host threads, its build "
          f"{build_s:.2f} s")

    poses, gold, truth, counts = _golden_log_run(torch.float32, "rollout_local", dev)
    want = {n: {"rollout_local": 11, "ndt_ingest": 12}.get(n, 0) for n in counts}
    check(counts == want, f"11b: rollout_local over 12 scans launched {counts}, expected {want}")
    eng, ref = _accuracy("11b rollout_local f32", poses, gold, truth)
    per_scan = np.abs(poses - gold).max(1)
    print(f"[phase 11b] run_offline rollout_local (K1, {counts['rollout_local']} launches) "
          f"float32, 12 scans: RMSE to the truth {eng:.5f} m against the golden's {ref:.5f} m "
          f"(limit 1.5 x + 1e-3); max |dpose| to the golden per scan "
          f"{[float(f'{v:.3e}') for v in per_scan]}")

    poses, gold, truth, counts = _golden_log_run(torch.float64, "exact", dev)
    want = {n: 12 * int(n == "ndt_ingest") for n in counts}
    check(counts == want, f"11c: the exact float64 loop launched {counts}, expected {want}")
    eng, ref = _accuracy("11c exact f64", poses, gold, truth)
    per_scan = np.abs(poses - gold).max(1)
    differs = np.nonzero(per_scan > 0)[0]
    print(f"[phase 11c] run_offline exact float64 on the card, 12 scans: RMSE to the truth "
          f"{eng:.5f} m against the golden's {ref:.5f} m; max |dpose| to the golden "
          f"{per_scan.max():.3e}, first scan that differs: "
          f"{int(differs[0]) if len(differs) else 'none'}; per scan "
          f"{[float(f'{v:.3e}') for v in per_scan]}")
    print(f"[phase 11] wall {time.perf_counter() - t0:.1f} s; {_smi()}")


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
    node, lg, launches, step_p50, ingest_launches = phase_main()
    phase_main_og(node, lg)
    worst_main, ms, plain_ms, bnd, cluster, main_inputs = phase_main_kernel(node, lg)
    ingest = phase_ingest(node, lg, ingest_launches)
    phase_main_profile(node, lg)
    world = batch_world(BATCH, torch.device("cuda"))
    worst_small = phase_batch_kernels(world)
    timed = phase_batch(world)
    timed.update(phase_batch_small(world))
    timed.update(phase_batch_large(world))
    worst_small["rollout_local_turbo_global"] = worst_small["rollout_local_global"]
    tpu = "ndtpso_slam_tpu/ops/"
    kernels = [_entry("rollout_local", SRC + "rollout_local.cu", tpu + "pallas_rollout.py:551",
                      launches, max(worst, worst_main, worst_small["rollout_local"]), ms, plain_ms,
                      bnd, cluster=cluster), ingest]
    for name, source, replaces in (
        ("rollout_local_turbo", "rollout_local.cu", "pallas_rollout.py:618"),
        ("rollout", "rollout.cu", "pallas_rollout.py:111"),
        ("rollout_bf16", "rollout.cu", "pallas_rollout.py:262"),
        ("rollout_turbo", "rollout.cu", "pallas_rollout.py:148"),
        ("score", "score.cu", "pallas_score.py:41"),
        ("rollout_global", "rollout.cu", "pallas_rollout.py:111"),
        ("rollout_local_turbo_global", "rollout_local.cu", "pallas_rollout.py:618"),
    ):
        n_launch, k_ms, p_ms, wide_err, k_bnd, k_cluster = timed[name]
        extra = {} if name == "score" else dict(cluster=k_cluster)
        if name.endswith("_global"):
            extra["state"] = "global scratch"
        kernels.append(_entry(name, SRC + source, tpu + replaces, n_launch,
                              max(worst_small[name], wide_err), k_ms, p_ms, k_bnd, **extra))
    kernels.extend(phase_studies(timed["rollout"][1]))
    t0 = time.perf_counter()
    reloc = reloc_world(torch.device("cuda"))
    kernels.append(phase_reloc_c2(reloc))
    phase_chooser(reloc, main_inputs, step_p50)
    del reloc
    kernels.extend(phase_recovery(torch.device("cuda")))
    print(f"[phase 7] wall {time.perf_counter() - t0:.1f} s")
    kernels.append(phase_whole_node(lg, world))
    kernels.extend(phase_fleets_sessions(torch.device("cuda")))
    kernels.extend(phase_distributed(world, lg, {k: v[1] for k, v in timed.items()}))
    phase_golden(torch.device("cuda"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2]) if sys.argv[1:2] == ["--rank"] else main())
