"""The port held to the C++ golden reference (``native/golden/golden.cpp``,
through the port's own binding ``utils/native.py``), on the CPU: the
acceptance rule of BASELINE.json, pose RMSE <= 1e-3 m / 1e-3 rad against the
golden under identical particle count, iteration budget and cell size
(config 1: 360-beam scans, 1 m cells, 50 x 50).  Mirrors
tests/test_parity_golden.py, whose fixtures it rebuilds with the port.

The gate holds the exact-cost routes (``pso_solve`` with ``ndt_cost``, and
``solve_batch`` in exact; local_exact and rollout_local, K1's plain twin on
the CPU, too on seeds 0-5, where no particle moves a point out of their
25-cell stencil, which other seeds do: ROADMAP R9).  rollout and fast solve
the frozen-correspondence cost, another function, and stay held to the JAX
package (tests/test_torch_batch.py).

The float32 trajectory.  Before the port's ``load_laser`` took its bearings'
cos and sin in float64, its float32 SLAM loop on ``_slam_vs_golden``'s log
parted from the JAX package's at scan 4 (3.05e-3) and ended 0.0957 m from
the golden run on its own points, against the JAX package's 0.0277 from the
golden on its points: PyTorch's float32 cos of beam 158's bearing in scan 0
is one ulp above the correctly rounded value (XLA's), so the beam's x was
19.999998 where the JAX package has 19.999996; at the pose (8, 0, pi/2) the
world y + 32 m rounds to 52.0 in float32, so the point fell into cell 3376
instead of 3312, which then held 3 points and was built where the JAX map
holds 2 and is not (ROADMAP §3, F2).  At scan 4 the first PSO evaluation of
particle 32 saw that cell: -84.5480194 on the port, -82.3687744 in JAX, and
the argmin went to particle 32 instead of 29.  With the bearings correctly
rounded the port's trajectory equals the JAX package's to 2.4e-7 over the 12
scans, and the golden on the port's points is the golden on the JAX
package's points.  The ``gpu`` tests (skipped without a card;
``python -m pytest --noconftest -m gpu tests/test_torch_golden.py`` there)
hold K1 and the float64 loop on CUDA to the golden.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.io import synthetic as tsynth
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.models.pso import pso_solve
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops import rollout_local as trl
from ndtpso_slam_tpu_torch.ops.geometry import cell_index, transform_points
from ndtpso_slam_tpu_torch.parallel import mesh
from ndtpso_slam_tpu_torch.utils import native
from ndtpso_slam_tpu_torch.utils.profiling import trace

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import scan as jscan
    from ndtpso_slam_tpu.models import slam as jslam
    from ndtpso_slam_tpu.utils import native as jnative
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")

MAP = tcfg.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=8, slot_capacity=50)
SCAN = tcfg.ScanConfig(max_beams=384)
BEAMS = 360
G1_SEEDS = range(6)
G1_PSO = tcfg.PSOConfig(iterations=50, population=50)
G1_DEV = (0.4, 0.4, 0.08)
GATE = 1e-3  # BASELINE.json: pose RMSE <= 1e-3 m / 1e-3 rad
SLAM_KEY = (9, 17)
TRAJ_ATOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (tests/test_torch_fleet.py:
    one_thread): PyTorch's CPU ops beside other test workers otherwise wait
    on all their threads.  Both sides of every comparison run here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _world_scans(seed, dev="cpu"):
    """tests/test_parity_golden.py:_world_scans with the port: a reference
    scan at the origin and a query scan at a random true pose, on a 50 m
    box world."""
    rs = np.random.RandomState(seed)
    segs = tsynth.make_world(seed=seed, size=50.0, n_boxes=8)
    load = lambda r: tscan.load_laser(r.astype(np.float32), -np.pi, 2 * np.pi / BEAMS, 30.0,
                                      SCAN, MAP, device=dev)
    ref = load(tsynth.raycast(segs, np.zeros(3), BEAMS, -np.pi, 2 * np.pi / BEAMS, 30.0))
    true = rs.uniform([-0.25, -0.25, -0.04], [0.25, 0.25, 0.04])
    q = load(tsynth.raycast(segs, true, BEAMS, -np.pi, 2 * np.pi / BEAMS, 30.0))
    return ref, q, true


def _build_both(ref, n_obs=3, seed=1, dev="cpu"):
    """tests/test_parity_golden.py:_build_both: the same jittered points
    into the port's dense float32 map and the golden's sparse float64 one."""
    rs = np.random.RandomState(seed)
    state = tmap.init_map(MAP, device=dev)
    gold = native.GoldenMap(MAP.size_m, MAP.cell_side_m, MAP.window_slots, MAP.slot_capacity)
    pts0 = ref.points.cpu().numpy().astype(np.float64)
    valid = ref.valid.cpu().numpy()
    for _ in range(n_obs):
        pts = pts0 + rs.normal(0, 0.03, pts0.shape)
        tmap.add_points(state, MAP, torch.from_numpy(pts.astype(np.float32)).to(dev), ref.valid)
        tmap.build(state, MAP)
        gold.update(np.zeros(3), pts, valid)
        gold.build()
    return state, gold


def _g1_world(dev="cpu"):
    """Config 1 over the seeds: each seed's snapshot, query scan and golden
    pose (P=50, I=50, key (seed, seed + 100))."""
    snaps, queries, gold_poses = [], [], []
    for seed in G1_SEEDS:
        ref, q, _ = _world_scans(seed, dev)
        state, gold = _build_both(ref, seed=seed + 10, dev=dev)
        snaps.append(tmap.snapshot(state, MAP))
        queries.append(q)
        gpose, _ = gold.pso(q.points.cpu().numpy().astype(np.float64), np.zeros(3), G1_DEV,
                            (seed, seed + 100), iterations=G1_PSO.iterations,
                            population=G1_PSO.population, valid=q.valid.cpu().numpy())
        gold_poses.append(gpose)
    return snaps, queries, np.stack(gold_poses)


@pytest.fixture(scope="module")
def g1_world():
    return _g1_world()


def _solve_batch(snaps, queries, mode, dev):
    b = len(snaps)
    stack = lambda f: torch.stack([getattr(s, f) for s in snaps])
    keys = torch.tensor([[s, s + 100] for s in G1_SEEDS], dtype=torch.int64, device=dev)
    res = mesh.solve_batch(
        keys, torch.zeros(b, 3, device=dev), torch.tensor([G1_DEV] * b, device=dev),
        MapSnapshot(mean=stack("mean"), inv_cov=stack("inv_cov"), built=stack("built")),
        torch.stack([q.points for q in queries]), torch.stack([q.valid for q in queries]),
        MAP, G1_PSO, cost_mode=mode)
    return res.pose.cpu().numpy().astype(np.float64)


def _rmse(poses, gold_poses):
    d = poses - gold_poses
    return np.sqrt(np.mean(d[:, :2] ** 2)), np.sqrt(np.mean(d[:, 2] ** 2))


def _slam_cfg(dtype, cost_mode="exact"):
    """tests/test_parity_golden.py:_slam_vs_golden's configuration."""
    return tcfg.SlamConfig(pso=tcfg.PSOConfig(iterations=30, population=50), map=MAP,
                           scan=SCAN, og=tcfg.OccupancyGridConfig(enabled=False),
                           cost_mode=cost_mode, dtype=dtype)


def _slam_log():
    return tsynth.make_log(seed=6, n_scans=12, n_beams=BEAMS, world_size=40.0)


def _port_slam(dtype, cost_mode="exact", dev="cpu"):
    """The port's run_offline on the log against golden_slam_run on the same
    loaded points.  Returns (port poses, golden poses, log)."""
    cfg = _slam_cfg(dtype, cost_mode)
    log = _slam_log()
    loaded = [tscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max, cfg.scan,
                               cfg.map, dtype=dtype, device=dev) for r in log.ranges]
    scans = tscan.Scan(points=torch.stack([s.points for s in loaded]),
                       valid=torch.stack([s.valid for s in loaded]))
    state = tslam.init_slam(cfg, tuple(log.poses[0]), device=dev)
    _, poses, _ = tslam.run_offline(state, scans, SLAM_KEY, cfg)
    gold = native.golden_slam_run(
        scans.points.cpu().numpy().astype(np.float64), scans.valid.cpu().numpy(), log.poses[0],
        MAP.size_m, MAP.cell_side_m, MAP.window_slots, MAP.slot_capacity, SLAM_KEY,
        iterations=30, population=50)
    return poses.cpu().numpy().astype(np.float64), gold, log


def _gt_rmse(poses, log):
    return np.sqrt(np.mean((poses[:, :2] - log.poses[:, :2]) ** 2))


# ------------------------------------------------------------- the binding
def test_golden_builds_into_the_port_build_dir():
    (path,) = _build.build(native.LIB)
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path == native.LIB.path() and path.name.startswith("golden-")
    assert "native" not in path.parent.parts[-2:]
    assert native.golden()._name == str(path)


def test_golden_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "golden").mkdir()
    (tmp_path / "golden" / "golden.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="golden build failed"):
        _build.build(dataclasses.replace(native.LIB, root=tmp_path))
    assert not list((tmp_path / "_build").glob("*.so"))


@needs_jax
@pytest.mark.parametrize("what", ["threefry", "map_cells", "cost", "pso", "slam_run"])
def test_binding_equals_jax_binding(what):
    """The port's golden build and the JAX package's (native/build/) on the
    same inputs, bit for bit: one source, one set of flags."""
    if what == "threefry":
        c0, c1 = np.arange(1000, dtype=np.uint32), np.arange(5000, 6000, dtype=np.uint32)
        for a, b in zip(native.golden_threefry((123, 456), c0, c1),
                        jnative.golden_threefry((np.uint32(123), np.uint32(456)), c0, c1)):
            np.testing.assert_array_equal(a, b)
        return
    if what == "slam_run":
        log = _slam_log()
        pts = np.stack([tscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max,
                                         SCAN, MAP, device="cpu").points.numpy()
                        for r in log.ranges[:4]]).astype(np.float64)
        valid = np.ones(pts.shape[:2], bool)
        args = (pts, valid, log.poses[0], MAP.size_m, MAP.cell_side_m, MAP.window_slots,
                MAP.slot_capacity, SLAM_KEY)
        np.testing.assert_array_equal(native.golden_slam_run(*args, iterations=10, population=20),
                                      jnative.golden_slam_run(*args, iterations=10, population=20))
        return
    ref, q, _ = _world_scans(0)
    pts = ref.points.numpy().astype(np.float64)
    qpts, qval = q.points.numpy().astype(np.float64), q.valid.numpy()
    rs = np.random.RandomState(10)
    obs = [pts + rs.normal(0, 0.03, pts.shape) for _ in range(3)]
    maps = []
    for lib in (native, jnative):
        g = lib.GoldenMap(MAP.size_m, MAP.cell_side_m, MAP.window_slots, MAP.slot_capacity)
        for o in obs:
            g.update(np.zeros(3), o, ref.valid.numpy())
            g.build()
        maps.append(g)
    if what == "map_cells":
        n = 0
        for idx in range(MAP.num_cells):
            a, b = maps[0].cell(idx), maps[1].cell(idx)
            assert (a is None) == (b is None), idx
            if a is not None:
                np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
                n += 1
        assert n > 50
    elif what == "cost":
        for pose in np.random.RandomState(2).uniform([-0.3, -0.3, -0.05], [0.3, 0.3, 0.05],
                                                     (10, 3)):
            a, b = maps[0].cost(pose, qpts, qval), maps[1].cost(pose, qpts, qval)
            assert np.isfinite(a) and a == b
    else:
        a = maps[0].pso(qpts, np.zeros(3), G1_DEV, (3, 103), iterations=20, population=30,
                        valid=qval)
        b = maps[1].pso(qpts, np.zeros(3), G1_DEV, (np.uint32(3), np.uint32(103)),
                        iterations=20, population=30, valid=qval)
        np.testing.assert_array_equal(a[0], b[0])
        assert np.isfinite(a[1]) and a[1] == b[1]


def test_binding_takes_cpu_tensors():
    ref, q, _ = _world_scans(1)
    g = native.GoldenMap(MAP.size_m, MAP.cell_side_m, MAP.window_slots, MAP.slot_capacity)
    g.update(torch.zeros(3), ref.points, ref.valid)
    g.build()
    pose = np.array([0.1, -0.05, 0.01])
    assert g.cost(torch.from_numpy(pose), q.points, q.valid) == g.cost(
        pose, q.points.numpy().astype(np.float64), q.valid.numpy().astype(np.uint8))
    words = native.golden_threefry((1, 2), torch.arange(4, dtype=torch.int64),
                                   torch.zeros(4, dtype=torch.int64))
    assert words[0].dtype == np.uint32 and words[0].shape == (4,)


# -------------------------------------------------- the port against it
def test_map_cells_match_golden():
    ref, _, _ = _world_scans(0)
    state, gold = _build_both(ref)
    snap = tmap.snapshot(state, MAP)
    mean, icov = snap.mean.numpy(), snap.inv_cov.numpy()
    n_checked = 0
    for idx in np.nonzero(snap.built.numpy())[0]:
        cell = gold.cell(int(idx))
        assert cell is not None, f"the port built cell {idx}, the golden did not"
        gmean, gicov = cell
        np.testing.assert_allclose(mean[idx], gmean, atol=1e-4)
        scale = max(1.0, np.abs(gicov).max())
        np.testing.assert_allclose(icov[idx] / scale, gicov / scale, atol=2e-3)
        n_checked += 1
    assert n_checked > 50


def test_cost_matches_golden():
    ref, q, _ = _world_scans(0)
    state, gold = _build_both(ref)
    snap = tmap.snapshot(state, MAP)
    rs = np.random.RandomState(2)
    for _ in range(10):
        pose = rs.uniform([-0.3, -0.3, -0.05], [0.3, 0.3, 0.05])
        ours = float(tcost.ndt_cost(torch.tensor(pose, dtype=torch.float32), snap, q.points,
                                    q.valid, MAP))
        theirs = gold.cost(pose, q.points.numpy().astype(np.float64), q.valid.numpy())
        np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("route", ["pso_solve", "exact", "local_exact", "rollout_local"])
def test_g1_rmse_gate(g1_world, route):
    """BASELINE config 1: pose RMSE <= 1e-3 m / 1e-3 rad against the golden
    over seeds 0-5 (measured on the CPU: 7.48e-08 m / 1.88e-08 rad on every
    route)."""
    snaps, queries, gold_poses = g1_world
    if route == "pso_solve":
        poses = []
        for seed, snap, q in zip(G1_SEEDS, snaps, queries):
            cost_fn = lambda p, bind, snap=snap, q=q: tcost.ndt_cost(p, snap, q.points, q.valid,
                                                                     MAP)
            res = pso_solve((seed, seed + 100), torch.zeros(3), torch.tensor(G1_DEV), cost_fn,
                            G1_PSO)
            poses.append(res.pose.numpy().astype(np.float64))
        poses = np.stack(poses)
    else:
        poses = _solve_batch(snaps, queries, route, "cpu")
    rmse_xy, rmse_th = _rmse(poses, gold_poses)
    assert rmse_xy <= GATE, f"{route}: xy RMSE {rmse_xy:.2e} vs gate {GATE}"
    assert rmse_th <= GATE, f"{route}: theta RMSE {rmse_th:.2e} vs gate {GATE}"


@pytest.mark.parametrize("cost_mode", ["exact", "local_exact"])
def test_g2_float64_trajectory_equals_golden(cost_mode):
    """G2: in float64 the port's SLAM loop reproduces the golden loop (the
    JAX package's test_slam_trajectory_parity_x64_bitwise; measured 0.0)."""
    poses, gold, _ = _port_slam(torch.float64, cost_mode)
    np.testing.assert_allclose(poses, gold, rtol=0, atol=1e-12)


def test_slam_trajectory_accuracy_parity_f32():
    """tests/test_parity_golden.py:test_slam_trajectory_accuracy_parity_f32
    as written there, on the port's own float32 points (RMSE to the ground
    truth 0.00606 against the golden's 0.00897; 0.0277 from the golden at
    most, the JAX package's figure; 0.0957 before F2's fix, module
    docstring)."""
    poses, gold_poses, log = _port_slam(torch.float32)
    eng_rmse, gold_rmse = _gt_rmse(poses, log), _gt_rmse(gold_poses, log)
    assert eng_rmse < 1.5 * gold_rmse + 1e-3, (eng_rmse, gold_rmse)
    np.testing.assert_allclose(poses, gold_poses, atol=0.05)


@needs_jax
def test_f32_trajectory_equals_jax():
    """The port's float32 loop against the JAX package's on the same log,
    each loading its own points, over all 12 scans (2.4e-7 measured; before
    F2's fix 3.05e-3 from scan 4 on)."""
    poses, _, log = _port_slam(torch.float32)
    jc = jcfg.SlamConfig(pso=jcfg.PSOConfig(iterations=30, population=50),
                         map=jcfg.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=8,
                                             slot_capacity=50),
                         scan=jcfg.ScanConfig(max_beams=SCAN.max_beams),
                         og=jcfg.OccupancyGridConfig(enabled=False), cost_mode="exact")
    loaded = [jscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max, jc.scan,
                               jc.map) for r in log.ranges]
    scans = jscan.Scan(points=jnp.stack([s.points for s in loaded]),
                       valid=jnp.stack([s.valid for s in loaded]))
    key = (np.uint32(SLAM_KEY[0]), np.uint32(SLAM_KEY[1]))
    _, jposes, _ = jslam.run_offline(jslam.init_slam(jc, tuple(log.poses[0])), scans, key, jc)
    np.testing.assert_allclose(poses, np.asarray(jposes, np.float64), atol=TRAJ_ATOL)


@needs_jax
def test_f2_bearings_correctly_rounded():
    """F2's pin: load_laser's points are r times the correctly rounded
    float32 cos and sin of the float32 bearing, bit for bit, and beam 158
    of the log's first scan (PyTorch's float32 cos one ulp high there) is the
    JAX package's point and bins into the JAX package's cell."""
    log = _slam_log()
    got = tscan.load_laser(log.ranges[0], log.angle_min, log.angle_increment, log.range_max,
                           SCAN, MAP, device="cpu")
    r = np.zeros(SCAN.max_beams, np.float32)
    r[:BEAMS] = log.ranges[0]
    theta = (np.arange(SCAN.max_beams, dtype=np.float32) * np.float32(log.angle_increment)
             + np.float32(log.angle_min))
    want = np.stack([r * np.cos(theta.astype(np.float64)).astype(np.float32),
                     r * np.sin(theta.astype(np.float64)).astype(np.float32)], -1)
    np.testing.assert_array_equal(got.points.numpy(), want)
    jpt = np.asarray(jscan.load_laser(log.ranges[0], log.angle_min, log.angle_increment,
                                      log.range_max, jcfg.ScanConfig(max_beams=384)).points)[158]
    np.testing.assert_array_equal(got.points[158].numpy(), jpt)
    assert float(got.points[158, 0]) == np.float32(19.999996)
    assert float(torch.cos(torch.tensor(theta[158]))) != float(np.float32(np.cos(
        np.float64(theta[158]))))  # the one-ulp float32 cos this pins against
    world = transform_points(got.points[158], torch.tensor(log.poses[0], dtype=torch.float32))
    idx, inb = cell_index(world, size_m=MAP.size_m, cell_side_m=MAP.cell_side_m,
                          cells_per_side=MAP.cells_per_side)
    assert bool(inb) and int(idx) == 3312


R9_SEED = 35  # config 1's seed where the 25-cell stencil parts most (2.29e-2)


@needs_jax
def test_r9_stencil_cost_is_not_the_golden_function():
    """R9's pin.  local_exact and rollout_local (K1) score a point only in
    the 5 x 5 cells around its cell at the guess: a particle that moves it
    further scores it 0 where the golden's exact cost scores it.  At config
    1's deviation (0.4 m, 0.08 rad: 2.4 m at 30 m range) that changes the
    solve on 4 of seeds 0-63 (the G1 gate's RMSE over 64 solves: 2.75e-3 m,
    against 1.99e-4 m for exact).  On seed 35: the port's local_exact is
    2.29e-2 from the golden, the JAX package's local_exact on the same
    snapshot and points gives the port's pose (the reference's function),
    and the same solve with an 81-cell stencil (radius 4) gives the exact
    route's pose."""
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.parallel import mesh as jmesh

    ref, q, _ = _world_scans(R9_SEED)
    state, gold = _build_both(ref, seed=R9_SEED + 10)
    snap = tmap.snapshot(state, MAP)
    key = (R9_SEED, R9_SEED + 100)
    gpose, _ = gold.pso(q.points.numpy().astype(np.float64), np.zeros(3), G1_DEV, key,
                        iterations=50, population=50, valid=q.valid.numpy())
    guess, dev = torch.zeros(3), torch.tensor(G1_DEV)

    def solve(radius):
        if radius is None:
            fn = lambda p, bind: tcost.ndt_cost(p, snap, q.points, q.valid, MAP)
        else:
            nbr = tcost.bind_neighborhood(guess, snap, q.points, q.valid, MAP, radius=radius)
            fn = lambda p, bind: tcost.stencil_exact_cost(p, nbr, q.points, MAP)
        return pso_solve(key, guess, dev, fn, G1_PSO).pose.numpy().astype(np.float64)

    local, wide, exact = solve(2), solve(4), solve(None)
    assert np.abs(local - gpose).max() > 1e-2
    assert np.abs(exact - gpose).max() < 1e-6
    np.testing.assert_allclose(wide, exact, atol=1e-6)
    jsnap = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy())[None],
                                   jmap.MapSnapshot(mean=snap.mean, inv_cov=snap.inv_cov,
                                                    built=snap.built))
    jmc = jcfg.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=8, slot_capacity=50)
    jres = jmesh.solve_batch(jnp.asarray([key], jnp.uint32), jnp.zeros((1, 3)),
                             jnp.asarray([G1_DEV]), jsnap, jnp.asarray(q.points.numpy())[None],
                             jnp.asarray(q.valid.numpy())[None], jmc,
                             jcfg.PSOConfig(iterations=50, population=50),
                             cost_mode="local_exact")
    np.testing.assert_allclose(local, np.asarray(jres[0][0], np.float64), atol=TRAJ_ATOL)


# ---------------------------------------------------------------- tracing
def test_trace_writes_a_chrome_trace(tmp_path):
    cfg = _slam_cfg(torch.float32)
    cfg = dataclasses.replace(cfg, pso=tcfg.PSOConfig(iterations=3, population=8))
    log = _slam_log()
    state = tslam.init_slam(cfg, tuple(log.poses[0]), device="cpu")
    scans = [tscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max, cfg.scan,
                              cfg.map, device="cpu") for r in log.ranges[:2]]
    with trace(str(tmp_path / "tr")) as logdir:
        for i, sc in enumerate(scans):
            state, _, _ = tslam.slam_step(state, sc, (1, i), cfg)
    assert logdir == str(tmp_path / "tr")
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    text = open(os.path.join(logdir, files[0])).read()
    assert text and "aten::" in text
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_g1_rmse_gate_on_gpu(cuda_device):
    """K1 (solve_batch rollout_local, one launch at B=6) on maps built on the
    card, against the golden on the same jittered points."""
    snaps, queries, gold_poses = _g1_world(cuda_device)
    before = trl.pso_rollout_local.LAUNCHES
    poses = _solve_batch(snaps, queries, "rollout_local", cuda_device)
    assert trl.pso_rollout_local.LAUNCHES == before + 1
    rmse_xy, rmse_th = _rmse(poses, gold_poses)
    assert rmse_xy <= GATE and rmse_th <= GATE, (rmse_xy, rmse_th)


@pytest.mark.gpu
def test_float64_loop_on_gpu_tracks_like_the_golden(cuda_device):
    """The float64 exact loop on CUDA tensors: CUDA's double sin/cos/exp are
    not glibc's, so the accuracy condition, not bit equality."""
    poses, gold_poses, log = _port_slam(torch.float64, "exact", cuda_device)
    assert np.isfinite(poses).all() and poses.shape == (12, 3)
    eng_rmse, gold_rmse = _gt_rmse(poses, log), _gt_rmse(gold_poses, log)
    assert eng_rmse < 1.5 * gold_rmse + 1e-3, (eng_rmse, gold_rmse)
