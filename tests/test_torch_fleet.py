"""The port's flat fleet (parallel/fleet.py) and run_offline_batch against
the port's solo runs and the JAX package's fleet, on the CPU: mirrors of
tests/test_parallel.py's flat-fleet cases and of tests/test_fleet_recovery.py.

Tolerances, with their reasons:

* the port's fleet against the port's solo runs: bit for bit (the same
  arithmetic per robot on the same rows in the same order), poses, costs
  and every map field;
* the port's fleet against the JAX fleet on the JAX package's scan points:
  poses 5e-4 (tests/test_torch_slam.py's trajectory tolerance: XLA-CPU and
  PyTorch differ in the last ulps of exp and sin/cos), the integer and bool
  map fields and the sparse ring's rows equal;
* fleet recovery against the JAX pool: the accept decision (recoveries) and
  the final poses; stage-1 near-ties are not compared (ROADMAP R5, as
  tests/test_torch_recovery.py does).

The ``gpu`` tests (the fleet on the card against its solo runs at equal
cluster size; the flat build's ``row_scatter`` launches against the plain
version) skip here.  The GPU machine has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_fleet.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.io import synthetic as tsynth
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.ops import rollout_local as trl
from ndtpso_slam_tpu_torch.ops import row_scatter as trs
from ndtpso_slam_tpu_torch.ops.geometry import cell_index, transform_points
from ndtpso_slam_tpu_torch.parallel import fleet as tfleet
from ndtpso_slam_tpu_torch.parallel.sessions import SlamSessionPool
from ndtpso_slam_tpu_torch.utils.state import (
    fleet_state_from_numpy,
    fleet_state_to_numpy,
    slam_state_to_numpy,
)

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import scan as jscan
    from ndtpso_slam_tpu.models import slam as jslam
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's tests.  Beside other test
    workers on a shared host, each parallel region of PyTorch's CPU ops
    waits until all of its threads are scheduled: this module's steps ran
    25-70x slower than alone with 8 threads on a loaded host, and as fast
    as alone with one.  No comparison here depends on the thread count:
    both sides of each run in this process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRAJ_ATOL = 5e-4
B = 3
N_SCANS = 10
N_BEAMS = 256


def _fleet_cfg(m, ring_rows=0, cost_mode="local_exact"):
    """tests/test_parallel.py:_fleet_fixture's configuration."""
    return m.SlamConfig(
        pso=m.PSOConfig(iterations=15, population=50),
        map=m.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4, slot_capacity=20,
                        ring_rows=ring_rows),
        scan=m.ScanConfig(max_beams=N_BEAMS),
        og=m.OccupancyGridConfig(enabled=False),
        cost_mode=cost_mode,
    )


def _logs():
    return [tsynth.make_log(seed=20 + r, n_scans=N_SCANS, n_beams=N_BEAMS, world_size=40.0,
                            odom_noise=0.02) for r in range(B)]


@pytest.fixture(scope="module")
def fixture():
    """The fleet fixture's logs, start poses, keys and scans [B, T, ...]:
    the JAX package's scan points where JAX is present (both packages then
    run on the same points), else the port's."""
    logs = _logs()
    if jax is not None:
        cfg = _fleet_cfg(jcfg)
        load = lambda r: jscan.load_laser(r, logs[0].angle_min, logs[0].angle_increment,
                                          logs[0].range_max, cfg.scan, cfg.map)
    else:
        cfg = _fleet_cfg(tcfg)
        load = lambda r: tscan.load_laser(r, logs[0].angle_min, logs[0].angle_increment,
                                          logs[0].range_max, cfg.scan, cfg.map, device="cpu")
    loaded = [[load(r) for r in lg.ranges] for lg in logs]
    points = np.stack([[np.asarray(s.points) for s in row] for row in loaded])
    valid = np.stack([[np.asarray(s.valid) for s in row] for row in loaded])
    init = np.stack([lg.poses[0] for lg in logs]).astype(np.float32)
    keys = np.stack([np.full(B, 3), np.arange(9, 9 + B)], -1).astype(np.uint32)
    return dict(logs=logs, points=points, valid=valid, init=init, keys=keys)


def _scans(fx, robots=B, steps=N_SCANS, device="cpu"):
    to = lambda a: torch.from_numpy(a[:robots, :steps]).to(device)
    return tscan.Scan(points=to(fx["points"]), valid=to(fx["valid"]))


def _solo(cfg, fx, r, steps=N_SCANS, device="cpu"):
    scans = _scans(fx, steps=steps, device=device)
    state = tslam.init_slam(cfg, tuple(fx["init"][r]), device)
    return tslam.run_offline(state, tscan.Scan(points=scans.points[r], valid=scans.valid[r]),
                             tuple(int(k) for k in fx["keys"][r]), cfg)


def _fleet(cfg, fx, robots=B, steps=N_SCANS, device="cpu"):
    states = tslam.init_slam_batch(cfg, fx["init"][:robots], device)
    return tfleet.run_offline_fleet(states, _scans(fx, robots, steps, device),
                                    fx["keys"][:robots], cfg)


# ------------------------------------------------ the fleet against solo


@pytest.mark.parametrize("ring_rows", [0, 512])
def test_fleet_flat_matches_solo_bitwise(fixture, ring_rows):
    """run_offline_fleet == per-robot run_offline, bit for bit: poses, costs
    and every map field (the flat update is the solo arithmetic per
    robot)."""
    cfg = _fleet_cfg(tcfg, ring_rows)
    fstates, fposes, fcosts = _fleet(cfg, fixture)
    farrays = fleet_state_to_numpy(fstates)
    for r in range(B):
        solo, sposes, scosts = _solo(cfg, fixture, r)
        assert torch.equal(fposes[r], sposes), f"robot {r} poses"
        assert torch.equal(fcosts[r], scosts), f"robot {r} costs"
        for k, v in slam_state_to_numpy(solo).items():
            np.testing.assert_array_equal(farrays[k][r], v, err_msg=f"robot {r} {k}")
    if ring_rows:
        assert (farrays["map.ring_used"] > 0).all() and (farrays["map.ring_overflow"] == 0).all()


def test_fleet_rollout_local_matches_solo_bitwise(fixture):
    """The rollout_local fleet (one K1 call with B = robots; on the CPU its
    plain version) reproduces each robot's solo run, poses, costs and map."""
    cfg = _fleet_cfg(tcfg, cost_mode="rollout_local")
    before = trl.pso_rollout_local.LAUNCHES
    fstates, fposes, fcosts = _fleet(cfg, fixture, robots=2, steps=5)
    assert trl.pso_rollout_local.LAUNCHES == before  # the CPU path never launches
    for r in range(2):
        solo, sposes, scosts = _solo(cfg, fixture, r, steps=5)
        assert torch.equal(fposes[r], sposes) and torch.equal(fcosts[r], scosts), f"robot {r}"
        assert torch.equal(fstates.map.mean_c[r], solo.map.mean_c), f"robot {r} map"


def test_fleet_flat_matches_run_offline_batch(fixture):
    """run_offline_batch (the solo step per robot on its views) and the flat
    fleet give the same results and the same states."""
    cfg = _fleet_cfg(tcfg)
    fstates, fposes, fcosts = _fleet(cfg, fixture, robots=2, steps=6)
    bstates = tslam.init_slam_batch(cfg, fixture["init"][:2], "cpu")
    bstates, bposes, bcosts = tslam.run_offline_batch(bstates, _scans(fixture, 2, 6),
                                                      fixture["keys"][:2], cfg)
    assert torch.equal(fposes, bposes) and torch.equal(fcosts, bcosts)
    fa, ba = fleet_state_to_numpy(fstates), fleet_state_to_numpy(bstates)
    for k in fa:
        np.testing.assert_array_equal(fa[k], ba[k], err_msg=k)


def test_run_offline_batch_runs_the_raster(fixture):
    """run_offline_batch carries what the flat fleet refuses: the occupancy
    raster, each session's bit for bit its solo run's."""
    cfg = dataclasses.replace(_fleet_cfg(tcfg), og=tcfg.OccupancyGridConfig(
        enabled=True, cell_size_m=0.5))
    states = tslam.init_slam_batch(cfg, fixture["init"][:2], "cpu")
    states, poses, _ = tslam.run_offline_batch(states, _scans(fixture, 2, 4),
                                               fixture["keys"][:2], cfg)
    for r in range(2):
        solo, sposes, _ = _solo(cfg, fixture, r, steps=4)
        assert torch.equal(poses[r], sposes)
        assert torch.equal(states.og.og[r], solo.og.og) and int(solo.og.og.count_nonzero()) > 0
        assert int(states.og.max_x[r]) == int(solo.og.max_x)


def test_fleet_flat_rejects_unsupported_configs(fixture):
    cfg = _fleet_cfg(tcfg)
    states = tslam.init_slam_batch(cfg, fixture["init"][:2], "cpu")
    scans = _scans(fixture, 2, 2)
    for bad in (
        # Offline runners cannot escalate mid-run; recovery fleets go
        # through fleet_pool_step + relocalize_fleet_robot.
        dataclasses.replace(cfg, recovery=tcfg.RecoveryConfig(enabled=True)),
        dataclasses.replace(cfg, og=tcfg.OccupancyGridConfig(enabled=True)),
        # Rollout modes run the deployed PSO rule only.
        dataclasses.replace(cfg, cost_mode="rollout", optimizer="glir"),
        dataclasses.replace(cfg, cost_mode="rollout_brf16"),
    ):
        with pytest.raises(ValueError):
            tfleet.run_offline_fleet(states, scans, fixture["keys"][:2], bad)
    tfleet._check_fleet_cfg(dataclasses.replace(cfg, recovery=tcfg.RecoveryConfig(enabled=True)),
                            allow_recovery=True)


def test_fleet_sharded_at_world_one_is_the_fleet(fixture):
    """At world 1 the sharded fleet is run_offline_fleet, bit for bit, and
    the sharded runner refuses what the fleet refuses
    (tests/test_torch_distributed.py runs it over 4 ranks)."""
    from ndtpso_slam_tpu_torch.parallel import mesh as tmesh

    cfg, mesh = _fleet_cfg(tcfg), tmesh.make_mesh(device="cpu")
    _, poses, costs = tfleet.run_offline_fleet_sharded(
        mesh, tslam.init_slam_batch(cfg, fixture["init"], "cpu"), _scans(fixture, steps=4),
        fixture["keys"], cfg)
    _, rposes, rcosts = _fleet(cfg, fixture, steps=4)
    assert torch.equal(poses, rposes) and torch.equal(costs, rcosts)
    with pytest.raises(ValueError):
        tfleet.make_fleet_sharded(mesh, dataclasses.replace(cfg, og=tcfg.OccupancyGridConfig(
            enabled=True)))


def _build_inputs(cfg, fx, steps=4):
    """A fleet's map after ``steps`` scans with the next scan added at the
    current poses, and the ids of that scan's build (its cells and the
    previous scan's)."""
    states, _, _ = _fleet(cfg, fx, steps=steps)
    scans = _scans(fx, steps=steps + 1)
    wpts = transform_points(scans.points[:, steps], states.pose)
    idx, inb = cell_index(wpts, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
                          cells_per_side=cfg.map.cells_per_side)
    valid = scans.valid[:, steps]
    ids = torch.where(valid & inb, idx, cfg.map.num_cells).to(torch.int32)
    tfleet.fleet_add_points(states.map, cfg.map, wpts, valid)
    return states.map, torch.cat([ids, states.prev_ids], dim=1)


def _clone(ms, device="cpu"):
    return ms.__class__(**{f.name: getattr(ms, f.name).clone().to(device)
                           for f in dataclasses.fields(ms)})


def _indexed(ops, idx, vals):
    for op, v in zip(ops, vals):
        op[idx] = v
    return ops


@pytest.mark.parametrize("ring_rows", [0, 512])
def test_fleet_build_row_scatter_matches_indexed_assignment(fixture, monkeypatch, ring_rows):
    """The flat build's float32 fields written through row_scatter (its
    plain version on the CPU: two calls of M = B·2N rows) equal the same
    build written by indexed assignment, every row of every field, the
    robots' spare rows included."""
    cfg = _fleet_cfg(tcfg, ring_rows)
    ms, ids = _build_inputs(cfg, fixture)
    a, b = _clone(ms), _clone(ms)
    calls = []
    real = tfleet.row_scatter
    monkeypatch.setattr(tfleet, "row_scatter", lambda *x: calls.append(x[1].shape) or real(*x))
    tfleet.fleet_build_touched(a, cfg.map, ids)
    assert calls == [(B * 2 * N_BEAMS,)] * 2
    monkeypatch.setattr(tfleet, "row_scatter", _indexed)
    tfleet.fleet_build_touched(b, cfg.map, ids)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_float64_map_takes_indexed_assignment(fixture, monkeypatch):
    """A map of another dtype than float32 never reaches row_scatter."""
    cfg = dataclasses.replace(_fleet_cfg(tcfg), dtype=torch.float64)
    monkeypatch.setattr(tfleet, "row_scatter", lambda *x: pytest.fail("row_scatter on float64"))
    states = tslam.init_slam_batch(cfg, fixture["init"], "cpu")
    scans = _scans(fixture, steps=3)
    scans = tscan.Scan(points=scans.points.double(), valid=scans.valid)
    _, poses, _ = tfleet.run_offline_fleet(states, scans, fixture["keys"], cfg)
    assert poses.dtype == torch.float64 and torch.isfinite(poses).all()


# ------------------------------------------------ the fleet against JAX


@needs_jax
def test_fleet_matches_jax_fleet(fixture):
    """The port's fleet against the JAX run_offline_fleet on the same scan
    points, sparse ring: poses within 5e-4 over the run, every integer and
    bool map field and the ring's rows equal."""
    from ndtpso_slam_tpu.parallel.fleet import run_offline_fleet as jax_fleet

    jc, tc = _fleet_cfg(jcfg, 512), _fleet_cfg(tcfg, 512)
    jscans = jscan.Scan(points=jnp.asarray(fixture["points"]), valid=jnp.asarray(fixture["valid"]))
    jstates, jposes, _ = jax_fleet(jslam.init_slam_batch(jc, fixture["init"]), jscans,
                                   fixture["keys"], jc)
    tstates, tposes, _ = _fleet(tc, fixture)
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), atol=TRAJ_ATOL)
    tarrays = fleet_state_to_numpy(tstates)
    for name in ("built", "created", "g_count", "slot_count", "slot_idx", "rot_count",
                 "cur_count", "ring_map", "ring_used", "ring_overflow"):
        np.testing.assert_array_equal(tarrays[f"map.{name}"],
                                      np.asarray(getattr(jstates.map, name)), err_msg=name)
    np.testing.assert_array_equal(tarrays["step"], np.asarray(jstates.step))
    np.testing.assert_array_equal(tarrays["prev_ids"], np.asarray(jstates.prev_ids))


# ------------------------------------- mirrors of tests/test_fleet_recovery.py

R_BEAMS = 360


def _rcfg(m):
    """tests/test_fleet_recovery.py's configuration."""
    return m.SlamConfig(
        pso=m.PSOConfig(iterations=30, population=50),
        map=m.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=8),
        scan=m.ScanConfig(max_beams=R_BEAMS),
        og=m.OccupancyGridConfig(enabled=False),
        recovery=m.RecoveryConfig(enabled=True, fitness_threshold=0.2,
                                  spread=(3.0, 3.0, np.pi), grid=(24, 24, 16)),
        cost_mode="exact",
    )


def _ranges(segs, pose):
    return tsynth.raycast(segs, np.asarray(pose, np.float64), R_BEAMS, -np.pi,
                          2 * np.pi / R_BEAMS, 30.0).astype(np.float32)


def _both_scans(ranges):
    """The JAX package's scan of the ranges (or None without JAX) and the
    port's scan of the same points."""
    if jax is None:
        cfg = _rcfg(tcfg)
        return None, tscan.load_laser(ranges, -np.pi, 2 * np.pi / R_BEAMS, 30.0, cfg.scan,
                                      cfg.map, device="cpu")
    cfg = _rcfg(jcfg)
    js = jscan.load_laser(ranges, -np.pi, 2 * np.pi / R_BEAMS, 30.0, cfg.scan, cfg.map)
    return js, tscan.Scan(points=torch.from_numpy(np.array(js.points)),
                          valid=torch.from_numpy(np.array(js.valid)))


def _pools(init, base_keys):
    from ndtpso_slam_tpu.parallel.sessions import SlamSessionPool as JPool

    tpool = SlamSessionPool(_rcfg(tcfg), np.float32(init), base_keys, device="cpu")
    assert tpool._use_flat, "a recovery fleet takes the flat step"
    return JPool(_rcfg(jcfg), np.float32(init), base_keys), tpool


def _poll_both(jpool, tpool, ranges_per_robot):
    """One poll of each pool on the same scans; ({session: pose}, {...})."""
    scans = [_both_scans(rg) for rg in ranges_per_robot]
    out = []
    for pool, side in ((jpool, 0), (tpool, 1)):
        for sid, sc in enumerate(scans):
            pool.submit(sid, sc[side])
        out.append({sid: np.asarray(p, np.float64) for sid, (p, _) in pool.poll().items()})
    return out


def _tcounts(pool, r):
    """Points robot r's map holds: window counts and open slots."""
    m = pool.states.map
    return int(m.g_count[r][:-1].sum()) + int(m.cur_count[r][:-1].sum())


def _jax_fleet_arrays(states):
    """A JAX stacked state as {JAX field path: numpy array [B, ...]}."""
    out = {f"map.{f.name}": np.asarray(getattr(states.map, f.name))
           for f in dataclasses.fields(states.map)}
    for name in ("prev_pose", "pose_diff", "iter"):
        out[f"align.{name}"] = np.asarray(getattr(states.align, name))
    for name in ("pose", "step", "fitness", "recoveries", "prev_ids"):
        out[name] = np.asarray(getattr(states, name))
    return out


@needs_jax
def test_fleet_kidnapped_robot_relocalizes_others_untouched():
    """The kidnapped robot of a 2-robot pool relocalizes through the host
    escalation: one accepted recovery, as in the JAX pool, within 0.3 m of
    the truth; the healthy robot is bit for bit its solo run, poses and map.

    The two packages' relocalized poses are compared from one state: the
    JAX pool's state after the crawl, continued by the port's pool through
    the kidnap, lands within 5e-4 of the JAX pool's pose with the same
    accept decision.  Over the whole run the two maps differ in float32
    ulps and the relocalization lands 5 mm apart (ROADMAP R5)."""
    segs = tsynth.make_world(seed=11, size=40.0, n_boxes=6)
    crawl = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(8)]
    kidnap = (2.4, -1.6, 0.5)
    r1 = crawl + [kidnap, (kidnap[0] + 0.05, kidnap[1], kidnap[2])]
    r0 = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(10)]
    ranges = [[_ranges(segs, r0[t]), _ranges(segs, r1[t])] for t in range(10)]
    base_keys = np.array([[21, 9], [21, 10]], np.uint32)
    jpool, tpool = _pools([r0[0], r1[0]], base_keys)
    hist = [[], []]
    for t in range(10):
        if t == 8:
            # A copy of the JAX pool after the crawl, and a port pool from
            # its state, through the kidnap.
            jcopy, from_jax = _pools([r0[0], r1[0]], base_keys)
            jcopy.states = jax.tree_util.tree_map(jnp.copy, jpool.states)
            jcopy.steps = jpool.steps.copy()
            from_jax.states = fleet_state_from_numpy(_jax_fleet_arrays(jpool.states),
                                                     from_jax.cfg, "cpu")
            for k in (8, 9):
                jres, tres = _poll_both(jcopy, from_jax, ranges[k])
                np.testing.assert_allclose(tres[1], jres[1], atol=TRAJ_ATOL)
            assert int(from_jax.states.recoveries[1]) == 1 == int(jcopy.states.recoveries[1])
        jres, tres = _poll_both(jpool, tpool, ranges[t])
        for h, res in zip(hist, (jres, tres)):
            h.append(np.stack([res[0], res[1]]))
    jest, test = np.stack(hist[0]), np.stack(hist[1])
    np.testing.assert_array_equal(tpool.states.recoveries, np.asarray(jpool.states.recoveries))
    assert list(tpool.states.recoveries) == [0, 1]
    err1 = np.hypot(*(test[:, 1, :2] - np.asarray(r1)[:, :2]).T)
    assert err1[-2] < 0.3 and err1[-1] < 0.3, err1
    assert float(tpool.states.align.pose_diff[1].abs().max()) < 0.5

    cfg = _rcfg(tcfg)
    solo = tslam.init_slam(cfg, tuple(r0[0]), "cpu")
    scans0 = [_both_scans(rg[0])[1] for rg in ranges]
    solo, sposes, _ = tslam.run_offline(solo, tscan.Scan(
        points=torch.stack([s.points for s in scans0]),
        valid=torch.stack([s.valid for s in scans0])), tuple(base_keys[0]), cfg)
    np.testing.assert_array_equal(test[:, 0], sposes.numpy().astype(np.float64))
    for name in ("mean_c", "g_count"):
        assert torch.equal(getattr(tpool.states.map, name)[0], getattr(solo.map, name)), name


@needs_jax
def test_fleet_dropout_dead_reckons_in_step():
    """A dropout scan in a fleet dead-reckons in the step (no escalation)
    and is not ingested; the next scan tracks again; the JAX pool's poses
    match."""
    segs = tsynth.make_world(seed=12, size=40.0, n_boxes=6)
    poses = [(0.1 * i, 0.05 * i, 0.0) for i in range(6)]
    jpool, tpool = _pools([poses[0], poses[0]], np.array([[31, 5], [31, 6]], np.uint32))
    for t in range(4):
        _poll_both(jpool, tpool, [_ranges(segs, poses[t])] * 2)
    diff_before = tpool.states.align.pose_diff[1].numpy().copy()
    pose_before = tpool.states.pose[1].numpy().copy()
    counts_before = _tcounts(tpool, 1)
    dead = np.zeros(R_BEAMS, np.float32)
    jres, tres = _poll_both(jpool, tpool, [_ranges(segs, poses[4]), dead])
    np.testing.assert_allclose(tres[1], pose_before + diff_before, atol=1e-6)
    np.testing.assert_allclose(tres[1], jres[1], atol=TRAJ_ATOL)
    assert _tcounts(tpool, 1) == counts_before, "the dropout scan was ingested"
    assert int(tpool.states.recoveries[1]) == 0 == int(jpool.states.recoveries[1])
    jres, tres = _poll_both(jpool, tpool, [_ranges(segs, poses[5])] * 2)
    assert float(np.hypot(tres[1][0] - poses[5][0], tres[1][1] - poses[5][1])) < 0.15
    np.testing.assert_allclose(tres[1], jres[1], atol=TRAJ_ATOL)


@needs_jax
def test_fleet_escalation_rejects_unrecoverable_kidnap():
    """A kidnap far outside the relocalization spread is rejected, as by the
    JAX pool: the quarantined scans never ingested, no recovery counted, the
    robot still below the loss threshold on both sides; the healthy robot
    unaffected.  The pose kept is the failed align's, a solve on geometry
    the map has never seen: it has no basin, so the two packages' poses are
    not compared."""
    segs = tsynth.make_world(seed=11, size=40.0, n_boxes=6)
    crawl = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(8)]
    far = (12.0, -11.0, 0.4)
    jpool, tpool = _pools([crawl[0], crawl[0]], np.array([[71, 3], [71, 4]], np.uint32))
    for t in range(8):
        _poll_both(jpool, tpool, [_ranges(segs, crawl[t])] * 2)
    counts_before = _tcounts(tpool, 1)
    for _ in range(2):  # flagged and escalated on each poll
        jres, tres = _poll_both(jpool, tpool, [_ranges(segs, crawl[7]), _ranges(segs, far)])
    assert int(tpool.states.recoveries[1]) == 0 == int(jpool.states.recoveries[1])
    assert _tcounts(tpool, 1) == counts_before, "quarantined scans were ingested"
    assert float(tpool.states.fitness[1]) < tpool.cfg.recovery.fitness_threshold
    assert float(jpool.states.fitness[1]) < tpool.cfg.recovery.fitness_threshold
    assert int(tpool.states.recoveries[0]) == 0


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _port_fixture(steps):
    """The fleet fixture on the port's own scan points (the GPU machine has
    no JAX)."""
    logs = _logs()
    cfg = _fleet_cfg(tcfg)
    loaded = [[tscan.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max, cfg.scan,
                                cfg.map, device="cpu") for r in lg.ranges[:steps]] for lg in logs]
    return dict(points=np.stack([[s.points.numpy() for s in row] for row in loaded]),
                valid=np.stack([[s.valid.numpy() for s in row] for row in loaded]),
                init=np.stack([lg.poses[0] for lg in logs]).astype(np.float32),
                keys=np.stack([np.full(B, 3), np.arange(9, 9 + B)], -1).astype(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("cost_mode", ["rollout_local", "rollout"])
def test_fleet_matches_solo_at_equal_cluster_on_gpu(cuda_device, cost_mode):
    """On the card, one kernel launch per aligned fleet step with B = robots
    and two row_scatter launches per step; under deterministic algorithms
    each robot's poses are bit-equal to its solo run where the fleet's
    launch ran at the solo launches' cluster size, else within the
    trajectory tolerance."""
    from ndtpso_slam_tpu_torch.ops import rollout as tro

    steps = 6
    fx = _port_fixture(steps)
    cfg = _fleet_cfg(tcfg, cost_mode=cost_mode)
    kernel = trl.pso_rollout_local if cost_mode == "rollout_local" else tro.pso_rollout
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        k0, s0 = kernel.LAUNCHES, trs.row_scatter.LAUNCHES
        _, fposes, _ = _fleet(cfg, fx, steps=steps, device=cuda_device)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES - k0 == steps - 1 and trs.row_scatter.LAUNCHES - s0 == 2 * steps
        fleet_c = kernel.LAST_CLUSTER
        for r in range(B):
            _, sposes, _ = _solo(cfg, fx, r, steps=steps, device=cuda_device)
            if kernel.LAST_CLUSTER == fleet_c:
                assert torch.equal(fposes[r], sposes), f"robot {r}"
            else:
                torch.testing.assert_close(fposes[r], sposes, atol=TRAJ_ATOL, rtol=0)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.gpu
@pytest.mark.parametrize("ring_rows", [0, 512])
def test_fleet_build_row_scatter_on_gpu(cuda_device, ring_rows):
    """The flat build on the card: its two row_scatter launches give every
    row of every field the plain version's bits (the map and ids built on
    the CPU, so the atomics of the card's adds play no part)."""
    cfg = _fleet_cfg(tcfg, ring_rows)
    ms, ids = _build_inputs(cfg, _port_fixture(5))
    a, b = _clone(ms, cuda_device), _clone(ms, cuda_device)
    ids = ids.to(cuda_device)
    before = trs.row_scatter.LAUNCHES
    tfleet.fleet_build_touched(a, cfg.map, ids)
    torch.cuda.synchronize()
    assert trs.row_scatter.LAUNCHES == before + 2
    real = tfleet.row_scatter
    tfleet.row_scatter = trs.row_scatter_reference
    try:
        tfleet.fleet_build_touched(b, cfg.map, ids)
    finally:
        tfleet.row_scatter = real
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
