"""The harness's parts for a node with tracking-loss recovery, on the CPU:
the traffic's schedule (``lap_log`` plays the lap in order, ``kidnap_log``
carries the robot ahead now and then), the reference's relocalization held
to the program's in float64, the set-up's check of the ``recovery`` block,
whole runs of the node through a kidnap log at small sizes, the program
correct and two faults of its relocalization not, and the card's time per
step as the node's untraced window takes it (a stand-in for CUPTI's clock):
marks for the kidnap cell only."""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

import bench_small
from bench_small import KIDNAP, NODE, SEED
from ndtbench import cell, drivers, judge as J, reference as R, synthetic

SMALL = NODE["traffic"]
LAP = dict(world_size_m=12.0, n_boxes=3, world_shift_m=[0.137, 0.291], radius_m=2.0,
           lap_scans=420, dt_s=0.1, n_beams=90, range_max_m=30.0, warmup_laps=1)
KID_TRAFFIC = dict(LAP, kind="kidnap_log", kidnap_every=10, jump_scans=[15, 25],
                   sample_events=32)


def fixed_window(monkeypatch, steps):
    """The window as ``steps`` steps, however fast the CPU runs them."""

    def timed(step, seconds):
        durations = []
        for _ in range(steps):
            t = time.perf_counter()
            step()
            durations.append(time.perf_counter() - t)
        return durations, sum(durations)

    monkeypatch.setattr(drivers, "timed", timed)


# ------------------------------------------------------------------ traffic


def test_lap_log_schedule_is_t_mod_lap():
    lap, sched = synthetic.NODE_TRAFFIC["lap_log"](dict(LAP, kind="lap_log"), SEED)
    assert np.array_equal(lap.ranges, synthetic.lap_log(LAP, SEED).ranges)
    assert [sched.index(t) for t in range(2000)] == [t % 420 for t in range(2000)]
    assert sched.kidnaps(0, 5000) == []


@pytest.mark.parametrize("seed", [SEED, 7])
def test_kidnap_schedule(seed):
    lap, sched = synthetic.kidnap_log(KID_TRAFFIC, seed)
    # The lap exactly as lap_log makes it.
    assert np.array_equal(lap.ranges, synthetic.lap_log(LAP, seed).ranges)
    n = 420
    steps = 420 + 5000
    idx = [sched.index(t) for t in range(steps)]
    # Warm-up in order; no kidnap before the window.
    assert idx[:n] == list(range(n))
    kid = sched.kidnaps(0, steps)
    assert kid == list(range(n + 9, steps, 10)) and kid[0] == n + 9
    assert sched.kidnaps(kid[3], kid[5] + 1) == kid[3:6]
    assert sched.kidnaps(kid[3] + 1, kid[5]) == [kid[4]]
    step = (np.diff(idx) % n).tolist()
    jumps = [step[t - 1] - 1 for t in kid]
    assert all(15 <= j <= 25 for j in jumps) and len(set(jumps)) > 5
    assert all(step[t - 1] == 1 for t in range(1, steps) if t not in set(kid))
    # The same seed gives the same schedule, however it is read.
    again = synthetic.kidnap_log(KID_TRAFFIC, seed).schedule
    assert [again.index(t) for t in reversed(range(steps))] == idx[::-1]
    other = synthetic.kidnap_log(KID_TRAFFIC, seed + 1).schedule
    assert [other.index(t) for t in range(steps)] != idx


# The patrol cell's judged numbers at its small size over a window of 30
# steps, as the harness gave them before it took a schedule and a recovery
# node (program, then the precision control).
PATROL_30 = {
    False: {"fitness_gap": 2.005882271816084e-05, "pose_xy_p75_m": 2.0341082096102596e-07,
            "pose_th_p75_rad": 7.506794663658667e-07, "score_gap_p75": 1.2500386854241707e-05,
            "parted_pct": 8.333333333333332, "map_off_pct": 0.0, "raster_off_pct": 0.0},
    True: {"fitness_gap": 0.23530891617942964, "pose_xy_p75_m": 0.009772941351032328,
           "pose_th_p75_rad": 0.012097845642208949, "score_gap_p75": 0.6787286083410253,
           "parted_pct": 91.66666666666666, "map_off_pct": 100.0,
           "raster_off_pct": 91.07142857142857}}


@pytest.mark.parametrize("control", [False, True])
def test_patrol_numbers_as_before(monkeypatch, control):
    fixed_window(monkeypatch, 30)
    r = bench_small.run("scan_launch.patrol", control=control)
    assert r["attempted"] == 30
    assert {k: c["value"] for k, c in r["checks"].items()} == PATROL_30[control]


# ---------------------------------------------------------- relocalization


def _relocalization_inputs(jump):
    """A float64 map of the small world built by the reference from one lap
    at the true poses, and the scan of pose ``jump`` of the lap, which the
    relocalization starts from pose 0 to find."""
    lap = synthetic.lap_log(LAP, SEED)
    b = lap.beams
    grid = R.Grid(40.0, 0.5)
    nmap = R.NdtMap(grid, 8, torch.float64, "cpu")
    pts, valid = R.scan_points(lap.ranges, b.angle_min, b.angle_increment, b.range_max, 96,
                               None, torch.float64, "cpu", frame_half=20.0)
    poses = torch.as_tensor(lap.poses)
    prev = torch.zeros(0, dtype=torch.int64)
    for i in range(0, 420, 3):
        ids = nmap.add(R.transform(pts[i], poses[i]), valid[i])
        nmap.build(torch.cat([ids, prev]))
        prev = ids
    return grid, nmap.snapshot(), pts[jump], valid[jump], poses[0], poses[jump]


@pytest.mark.parametrize("patch_cells", [0, 48])
@pytest.mark.parametrize("jump", [20, 35])
def test_reference_relocalization_equals_the_programs(monkeypatch, patch_cells, jump):
    """The reference's relocalization against the program's ``_relocalize``
    on the same float64 inputs.  The program rounds the map's table to
    float32 for its swarms (``cost.snapshot_table``); here it is kept in
    float64, so both sides compute the same numbers up to the order of
    their operations."""
    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.models import cost as cost_mod, slam
    from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
    from ndtpso_slam_tpu_torch.models.scan import Scan

    table = cost_mod.snapshot_table
    monkeypatch.setattr(cost_mod, "snapshot_table",
                        lambda snap, dtype=torch.float32: table(snap, snap.mean.dtype))
    grid, snap, pts, valid, last, _ = _relocalization_inputs(jump)
    rcfg = C.RecoveryConfig(enabled=True, patch_cells=patch_cells)
    cfg = C.SlamConfig(map=C.MapConfig(size_m=40.0, cell_side_m=0.5, window_slots=8),
                       recovery=rcfg, dtype=torch.float64)
    block = dataclasses.asdict(rcfg)
    failed = last + torch.tensor([0.05, -0.03, 0.01], dtype=torch.float64)
    key = R.node_key(SEED, 1234)
    got_pose, got_cost = slam._relocalize(key, MapSnapshot(*snap), Scan(pts, valid), last,
                                          failed, cfg)
    pose, cost = R.relocalize(key, snap, grid, pts, valid, last, failed, block)
    assert torch.allclose(pose, got_pose, rtol=0, atol=1e-9), (pose, got_pose)
    assert float(cost) == pytest.approx(float(got_cost), rel=1e-9)
    # The winner scores better than where the search started.
    assert float(cost) < float(R.exact_cost(last, snap, grid, pts, valid))


def test_motions_follow_the_programs_rule():
    # The motion kept after each step: the served motion; that of the step
    # before where the scan dead-reckoned (step 3); 0 where a relocalization
    # was accepted (step 4).
    served = np.array([[0, 0, 0], [1, 0, 0], [3, 0, 1], [6, 0, 0], [10, 0, 0], [15, 0, 0]], float)
    degraded = np.array([False, False, False, True, False, False])
    m = J._motions(served, degraded, {4})
    assert m.tolist() == [[0, 0, 0], [1, 0, 0], [2, 0, 1], [2, 0, 1], [0, 0, 0], [5, 0, 0]]


# ------------------------------------------------------------------- set-up


def test_setup_refuses_a_recovery_block_that_differs():
    from ndtpso_slam_tpu_torch import config as C

    rc = C.RecoveryConfig(enabled=True)
    block = KIDNAP["config"]["recovery"]
    assert drivers.recovery_block({"recovery": block}, rc) is block
    for key, value in (("patch_cells", 96), ("grid", [24, 24, 16]),
                       ("pso", dict(block["pso"], population=64)), ("fitness_threshold", 0.2)):
        with pytest.raises(ValueError, match=key):
            drivers.recovery_block({"recovery": dict(block, **{key: value})}, rc)
    with pytest.raises(ValueError, match="min_valid_beams"):
        drivers.recovery_block({"recovery": {k: v for k, v in block.items()
                                             if k != "min_valid_beams"}}, rc)
    with pytest.raises(ValueError, match="no recovery block"):
        drivers.recovery_block({}, rc)
    with pytest.raises(ValueError, match="recovery is off"):
        drivers.recovery_block({"recovery": block}, C.RecoveryConfig())
    assert drivers.recovery_block({}, C.RecoveryConfig()) is None


def test_setup_stops_a_run_whose_block_differs():
    more = cell._merge(KIDNAP, {"config": {"recovery": {"k_hypotheses": 4}}})
    with pytest.raises(ValueError, match="k_hypotheses"):
        bench_small.run("scan_launch.patrol", more=more)


# ---------------------------------------------------------------- whole runs

STEPS = 40  # window steps of a kidnap run: four kidnaps
EVENT_NUMBERS = ("event_xy_p75_m", "event_th_p75_rad", "event_score_gap_p75",
                 "accept_differ_pct")


def kidnap_run(monkeypatch, more=None, control=False):
    """A small node run through a kidnap log, its window ``STEPS`` steps:
    (the result line, the metrics' Context)."""
    seen = {}
    read = cell.read_metrics

    def spy(metrics, ctx):
        seen["ctx"] = ctx
        return read(metrics, ctx)

    monkeypatch.setattr(cell, "read_metrics", spy)
    fixed_window(monkeypatch, STEPS)
    # No kidnap in set-up: the window's four kidnaps follow the lap.
    monkeypatch.setattr(drivers, "WARMUP_KIDNAPS", 0)
    r = bench_small.run("scan_launch.patrol", more=cell._merge(KIDNAP, more), control=control)
    return r, seen["ctx"]


def test_kidnap_run_is_correct(monkeypatch):
    r, ctx = kidnap_run(monkeypatch)
    assert r["correct"], r["checks"]
    assert all(name in r["checks"] for name in EVENT_NUMBERS)
    assert "fitness_gap" in r["checks"]
    ev = ctx.events
    assert ev["kidnaps"] == [429, 439, 449, 459] and ev["timed_from"] == 420
    assert set(ev["kidnaps"]) & set(ev["accepted"])
    assert r["attempted"] == STEPS


def test_an_infinite_fitness_is_not_correct(monkeypatch):
    """One infinite fitness at a step whose fitness float32 fixes (step 2,
    always sampled, on a map of two scans' cells) fails the run."""
    from ndtpso_slam_tpu_torch.models import slam

    step = slam.slam_step

    def one_inf(state, *args):
        new, pose, cost = step(state, *args)
        if state.step == 2:
            new = dataclasses.replace(new, fitness=torch.full_like(new.fitness, float("inf")))
        return new, pose, cost

    monkeypatch.setattr(slam, "slam_step", one_inf)
    r, _ = kidnap_run(monkeypatch)
    assert not r["correct"]
    assert not math.isfinite(r["checks"]["fitness_gap"]["value"]), r["checks"]


def _one_cell_map(points, dtype=torch.float64):
    """A reference map whose one built cell holds ``points`` [n, 2] (world
    metres, cell (40, 40) of a 40 m frame of 0.5 m cells)."""
    grid = R.Grid(40.0, 0.5)
    nmap = R.NdtMap(grid, 8, dtype, "cpu")
    q = torch.as_tensor(points, dtype=dtype)
    ids = nmap.add(q, torch.ones(q.shape[0], dtype=torch.bool))
    nmap.build(ids)
    return grid, nmap.snapshot()


@pytest.mark.parametrize("spacing,fixed", [(0.02, True), (0.002, False)])
def test_fitness_spread_leaves_out_a_cell_float32_cannot_fix(spacing, fixed):
    """A wall's cell (points 2 cm apart on a line) fixes the score of a beam
    5 mm off its mean; a cell of three points 2 mm apart on a line, whose
    regularized inverse divides by ~1e-15, does not (PERF.md §6)."""
    base = torch.tensor([0.12, 0.07], dtype=torch.float64)
    along = torch.tensor([0.8, 0.6], dtype=torch.float64)
    n = 12 if fixed else 3
    pts = base + spacing * torch.arange(n, dtype=torch.float64)[:, None] * along
    grid, snap = _one_cell_map(pts)
    (cell,) = torch.nonzero(snap[2]).flatten().tolist()
    beam = snap[0][cell] + 0.005 * along
    spread = J.fitness_spread(grid, snap, torch.zeros(3, dtype=torch.float64), beam[None],
                              torch.ones(1, dtype=torch.bool))
    assert (spread <= J.FIT_RESOLVED) == fixed, spread


def test_kidnap_control_is_not_correct(monkeypatch):
    r, _ = kidnap_run(monkeypatch, control=True)
    assert not r["correct"], r["checks"]


def test_relocalization_never_accepted(monkeypatch):
    from ndtpso_slam_tpu_torch.models import slam

    def refused(key, snap, scan, last_pose, failed_pose, cfg):
        return failed_pose, torch.full((), float("inf"), dtype=last_pose.dtype)

    monkeypatch.setattr(slam, "_relocalize", refused)
    r, ctx = kidnap_run(monkeypatch)
    assert ctx.events["accepted"] == []
    assert not r["correct"], r["checks"]
    assert r["checks"]["accept_differ_pct"]["value"] > r["checks"]["accept_differ_pct"]["limit"]


def test_relocalized_pose_moved(monkeypatch):
    from ndtpso_slam_tpu_torch.models import slam

    relocalize = slam._relocalize

    def moved(*args):
        pose, cost = relocalize(*args)
        return pose + torch.tensor([0.2, 0.0, 0.0], dtype=pose.dtype), cost

    monkeypatch.setattr(slam, "_relocalize", moved)
    r, ctx = kidnap_run(monkeypatch)
    assert ctx.events["accepted"]
    assert not r["correct"], r["checks"]
    assert any(r["checks"][k]["value"] > r["checks"][k]["limit"] for k in EVENT_NUMBERS)


# -------------------------------------------- the card's time per kidnap step


class StandInClock:
    """``cupti.DeviceClock`` as ``run_node`` calls it, on the CPU: each mark
    a tick, the card busy 2 ms in every step, ``crossing`` of that in
    records across a mark."""

    crossing = 0.0
    made: list = []

    def __init__(self):
        self.marks, self.busy_s = [], None
        self.kernels = self.ops = self.left_out = 0
        StandInClock.made.append(self)

    def start(self, sync):
        sync()

    def mark(self):
        self.marks.append(len(self.marks))

    def stop(self, sync):
        sync()
        if self.marks:
            self.marks.append(len(self.marks))
        self.busy_s = 0.04

    def busy_between(self, marks):
        return np.full(len(marks) - 1, 2e-3)

    def crossing_share(self, marks):
        return self.crossing


def card_run(monkeypatch, workload, steps, crossing=0.0):
    """``workload`` at its small size with its window ``steps`` steps, as
    if on a card whose clock is a :class:`StandInClock`: (the result line,
    the metrics' Context, the relocalizations run before the window and in
    it)."""
    from ndtpso_slam_tpu_torch.models import slam

    StandInClock.made, StandInClock.crossing = [], crossing
    monkeypatch.setattr(drivers, "on_card", lambda device: True)
    monkeypatch.setattr(drivers.cupti, "DeviceClock", StandInClock)
    relocalize, ran, seen = slam._relocalize, [], {}

    def counted(*args):
        ran.append(1)
        return relocalize(*args)

    monkeypatch.setattr(slam, "_relocalize", counted)

    def timed(step, seconds):
        seen["before"] = len(ran)
        durations = []
        for _ in range(steps):
            t = time.perf_counter()
            step()
            durations.append(time.perf_counter() - t)
        return durations, sum(durations)

    monkeypatch.setattr(drivers, "timed", timed)
    read = cell.read_metrics

    def spy(metrics, ctx):
        seen["ctx"] = ctx
        return read(metrics, ctx)

    monkeypatch.setattr(cell, "read_metrics", spy)
    r = bench_small.run(workload)
    return r, seen["ctx"], (seen["before"], len(ran) - seen["before"])


def test_patrol_takes_no_marks(monkeypatch):
    r, ctx, ran = card_run(monkeypatch, "scan_launch.patrol", 12)
    (clock,) = StandInClock.made
    assert clock.marks == [] and ctx.step_busy_s is None and ran == (0, 0)
    assert set(r["metrics"]) == {"card_ms_per_scan", "setup_s"}
    assert r["metrics"]["card_ms_per_scan"]["value"] == pytest.approx(0.04 / 12 * 1e3)


def test_kidnap_cell_reads_each_kidnap_step(monkeypatch):
    r, ctx, (before, inside) = card_run(monkeypatch, "scan_launch_recovery.kidnap", 20)
    assert r["correct"], r["checks"]
    (clock,) = StandInClock.made
    assert len(clock.marks) == 21 and ctx.step_busy_s == [2e-3] * 20
    # The lap, then two kidnaps in set-up (steps 429 and 439): the
    # relocalization ran before the window; two kidnaps in the window.
    ev = ctx.events
    assert ev["timed_from"] == 440 and ev["kidnaps"] == [449, 459]
    assert before >= 1 and inside >= 1
    assert set(r["metrics"]) == {"card_ms_per_kidnap", "setup_s"}
    assert r["metrics"]["card_ms_per_kidnap"]["value"] == pytest.approx(2.0)


def test_steps_that_cannot_be_told_apart_fail_the_run(monkeypatch):
    with pytest.raises(RuntimeError, match="across a mark"):
        card_run(monkeypatch, "scan_launch_recovery.kidnap", 10, crossing=0.02)
