"""The port's occupancy raster against the JAX package, on the CPU.

Mirror of tests/test_occupancy.py, plus the raster inside the SLAM step.
The maps match bit for bit (tests/test_torch_map.py); the raster samples
each cell's Gaussian with ``exp``, whose last ulp differs between XLA and
PyTorch, and an ulp can carry ``p * 100`` across an int8 truncation
boundary.  So the rasters are held within 1 unit and the number of sub-cells
that differ is bounded and printed; bounding boxes are equal.

The ``gpu`` test runs the incremental update on the card with PyTorch's
sync debug mode set to error (it must add no host synchronization to the
SLAM step) and skips here; the GPU machine has no JAX, so run it there with
``python -m pytest --noconftest -m gpu tests/test_torch_occupancy.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import occupancy as tocc
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.ops import geometry as tgeo

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.io import synthetic as jsynth
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.models import occupancy as jocc
    from ndtpso_slam_tpu.models import scan as jscan
    from ndtpso_slam_tpu.models import slam as jslam
    from ndtpso_slam_tpu.ops import rng as jrng
except ImportError:  # the GPU machine: no JAX, only the gpu test runs
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")

# A 40 m map of 1 m cells, 0.1 m sub-cells (10 x 10 per cell, a 400 x 400
# raster), with tests/test_occupancy.py's window of 4 slots of 10 points.
MAP = dict(size_m=40.0, cell_side_m=1.0, window_slots=4, slot_capacity=10)
TMAP = tcfg.MapConfig(**MAP)
# R1's map: two slots of at most 2 points, so a ring wraps in two scans.
R1_MAP = dict(MAP, window_slots=2, slot_capacity=2)
TOG = tcfg.OccupancyGridConfig()  # 0.1 m, enabled
BOUNDS = ("min_x", "max_x", "min_y", "max_y")
# Sub-cells whose value may differ by 1 unit (an exp ulp across a
# truncation boundary); measured 0 or 1 on each raster below (printed).
MAX_OFF_BY_ONE = 8
TRAJ_ATOL = 5e-4
BASE_KEY = (3, 9)

if jax is not None:
    JMAP, JOG = jcfg.MapConfig(**MAP), jcfg.OccupancyGridConfig()
    _jog_update = jax.jit(jocc.og_update, static_argnums=(2, 3))
    _jog_incremental = jax.jit(jocc.og_update_incremental, static_argnums=(2, 3))
    _jadd_points = jax.jit(jmap.add_points, static_argnums=1)
    _jbuild = jax.jit(jmap.build, static_argnums=1)
    _jbuild_touched = jax.jit(jmap.build_touched, static_argnums=1)


def _assert_rasters_close(tog, jog, what):
    """Raster within 1 unit (counted), bounding box equal."""
    t = tog.og.numpy().astype(np.int32)
    j = np.asarray(jog.og).astype(np.int32)
    assert t.shape == j.shape and tog.og.dtype == torch.int8
    diff = np.abs(t - j)
    n_off = int((diff > 0).sum())
    print(f"{what}: {n_off} of {t.size} sub-cells differ by 1 unit")
    assert diff.max() <= 1 and n_off <= MAX_OFF_BY_ONE, (what, diff.max(), n_off)
    for name in BOUNDS:
        assert int(getattr(tog, name)) == int(getattr(jog, name)), (what, name)


def _clusters(seed, n_rounds, n_pts=64):
    """Clustered points, so cells accumulate enough for builds and rotations."""
    rs = np.random.RandomState(seed)
    for _ in range(n_rounds):
        centers = rs.uniform(-17, 17, (5, 2))
        pts = centers[rs.randint(0, 5, n_pts)] + rs.normal(0, 0.4, (n_pts, 2))
        yield pts.astype(np.float32), rs.rand(n_pts) > 0.1


def _ids(pts, valid):
    idx, inb = tgeo.cell_index(torch.from_numpy(pts), size_m=TMAP.size_m,
                               cell_side_m=TMAP.cell_side_m, cells_per_side=TMAP.cells_per_side)
    return torch.where(torch.from_numpy(valid) & inb, idx, TMAP.num_cells)


@needs_jax
@pytest.mark.parametrize("size_m,cell_side_m,og_cell", [(40.0, 1.0, 0.1), (32.0, 0.5, 0.15),
                                                        (300.0, 0.5, 0.1)])
def test_og_dims_and_init_match_jax(size_m, cell_side_m, og_cell):
    jm = jcfg.MapConfig(size_m=size_m, cell_side_m=cell_side_m)
    tm = tcfg.MapConfig(size_m=size_m, cell_side_m=cell_side_m)
    jo = jcfg.OccupancyGridConfig(cell_size_m=og_cell)
    to = tcfg.OccupancyGridConfig(cell_size_m=og_cell)
    assert tocc.og_dims(tm, to) == jocc.og_dims(jm, jo)
    if size_m > 100:
        return  # the 3000 x 3000 deployment raster: dimensions only
    t, j = tocc.init_og(tm, to, device="cpu"), jocc.init_og(jm, jo)
    np.testing.assert_array_equal(t.og.numpy(), np.asarray(j.og))
    assert t.buf.shape == (t.og.numel() + 1,) and t.og.data_ptr() == t.buf.data_ptr()
    for name in BOUNDS:
        assert int(getattr(t, name)) == int(getattr(j, name))
        assert getattr(t, name).dtype == torch.int32 and getattr(t, name).dim() == 0


@needs_jax
@pytest.mark.parametrize("seed", [7, 8])
def test_dense_and_incremental_match_jax(seed):
    """Both updates after every scan of a build-after-every-ingest run, each
    against the JAX package's; the port's incremental raster equals its
    dense one exactly (tests/test_occupancy.py's invariant)."""
    js, ts = jmap.init_map(JMAP), tmap.init_map(TMAP, device="cpu")
    jd, ji = jocc.init_og(JMAP, JOG), jocc.init_og(JMAP, JOG)
    td, ti = tocc.init_og(TMAP, TOG, "cpu"), tocc.init_og(TMAP, TOG, "cpu")
    for step, (pts, valid) in enumerate(_clusters(seed, 6)):
        js = _jbuild(_jadd_points(js, JMAP, pts, valid), JMAP)
        tmap.build(tmap.add_points(ts, TMAP, torch.from_numpy(pts), torch.from_numpy(valid)), TMAP)
        ids = _ids(pts, valid)
        jd = _jog_update(jd, js, JMAP, JOG)
        ji = _jog_incremental(ji, js, JMAP, JOG, jnp.asarray(ids.numpy()))
        td = tocc.og_update(td, ts, TMAP, TOG)
        ti = tocc.og_update_incremental(ti, ts, TMAP, TOG, ids)
        _assert_rasters_close(td, jd, f"dense, step {step}")
        _assert_rasters_close(ti, ji, f"incremental, step {step}")
        np.testing.assert_array_equal(ti.og.numpy(), td.og.numpy())
    for name in BOUNDS:
        assert int(getattr(ti, name)) == int(getattr(td, name)), name
    assert int(torch.count_nonzero(ti.og)) > 0


@needs_jax
def test_incremental_skips_unbuilt_and_out_of_range():
    ts = tmap.init_map(TMAP, device="cpu")
    og = tocc.init_og(TMAP, TOG, "cpu")
    # Two points in one cell: created but count <= 2, so not built.
    pts = np.float32([[1.2, 1.2], [1.3, 1.25]])
    tmap.build(tmap.add_points(ts, TMAP, torch.from_numpy(pts), torch.ones(2, dtype=torch.bool)), TMAP)
    ids = torch.cat([_ids(pts, np.ones(2, bool)), torch.tensor([TMAP.num_cells, -3])])
    out = tocc.og_update_incremental(og, ts, TMAP, TOG, ids)
    assert int(torch.count_nonzero(out.og)) == 0
    for name in BOUNDS:
        assert int(getattr(out, name)) == int(getattr(og, name))  # bbox untouched
    # The skipped writes went to the spare slot only; the JAX package agrees.
    js = jmap.build(jmap.add_points(jmap.init_map(JMAP), JMAP, pts, np.ones(2, bool)), JMAP)
    jout = _jog_incremental(jocc.init_og(JMAP, JOG), js, JMAP, JOG, jnp.asarray(ids.numpy()))
    _assert_rasters_close(out, jout, "unbuilt and out-of-range ids")


@needs_jax
def test_raster_int8_truncation_matches_xla():
    """p * 100 converted as XLA converts it: toward zero, saturating, NaN
    to 0, where a plain cast would wrap."""
    p = np.float32([np.nan, 3.0, -3.0, np.inf, 1.279, -0.005, 0.9999, 0.0099])
    got = tocc._to_int8(torch.from_numpy(p)).numpy()
    want = np.asarray((jnp.asarray(p) * 100.0).astype(jnp.int8))
    np.testing.assert_array_equal(got, want)


# ---- The raster inside the SLAM step.


def _slam_cfgs():
    """The default SlamConfig with the occupancy grid at its default
    (OccupancyGridConfig(): 0.1 m sub-cells, enabled): 30 particles, 50
    iterations, the exact cost, the 100-slot window of 50 points; cut to a
    40 m map of 1 m cells and 256 beams."""
    kw = lambda m: dict(map=m.MapConfig(size_m=40.0, cell_side_m=1.0),
                        scan=m.ScanConfig(max_beams=256), og=m.OccupancyGridConfig())
    return jcfg.SlamConfig(**kw(jcfg)), tcfg.SlamConfig(**kw(tcfg))


@pytest.fixture(scope="module")
def slam_runs():
    """8 scans through both packages' slam_step with the raster on, and the
    port again with it off."""
    log = jsynth.make_log(seed=3, n_scans=8, n_beams=256, world_size=30.0, odom_noise=0.02)
    jc, tc = _slam_cfgs()
    js, jp = jslam.init_slam(jc, tuple(log.poses[0])), []
    for i in range(8):
        sc = jscan.load_laser(log.ranges[i], log.angle_min, log.angle_increment, log.range_max,
                              jc.scan, jc.map)
        key = jrng.threefry2x32((np.uint32(BASE_KEY[0]), np.uint32(BASE_KEY[1])),
                                np.uint32(i), np.uint32(0))
        js, pose, _ = jslam.slam_step(js, sc, key, jc)
        jp.append(np.asarray(pose))
    runs = {}
    for enabled in (True, False):
        cfg = dataclasses.replace(tc, og=tcfg.OccupancyGridConfig(enabled=enabled))
        ts, tp = tslam.init_slam(cfg, tuple(log.poses[0]), device="cpu"), []
        for i in range(8):
            sc = tscan.load_laser(log.ranges[i], log.angle_min, log.angle_increment,
                                  log.range_max, cfg.scan, cfg.map, device="cpu")
            ts, pose, _ = tslam.slam_step(ts, sc, tslam.rng.derive_key(BASE_KEY, i), cfg)
            tp.append(pose.numpy())
        runs[enabled] = (ts, np.stack(tp))
    return dict(log=log, jstate=js, jposes=np.stack(jp), port=runs[True], port_off=runs[False])


@needs_jax
def test_slam_step_default_config_matches_jax(slam_runs):
    ts, tp = slam_runs["port"]
    np.testing.assert_allclose(tp, slam_runs["jposes"], atol=TRAJ_ATOL)
    assert ts.og is not None and ts.step == 8
    _assert_rasters_close(ts.og, slam_runs["jstate"].og, "slam_step, 8 scans")
    assert int(torch.count_nonzero(ts.og.og)) > 100


@needs_jax
def test_raster_on_leaves_poses_bit_equal(slam_runs):
    (on, p_on), (off, p_off) = slam_runs["port"], slam_runs["port_off"]
    assert off.og is None
    np.testing.assert_array_equal(p_on, p_off)
    np.testing.assert_array_equal(on.map.mean_c.numpy(), off.map.mean_c.numpy())


@needs_jax
def test_r1_incremental_raster_stale_as_in_jax():
    """ROADMAP R1: the SLAM step rebuilds this scan's and last scan's cells
    but refreshes the raster for this scan's only, so a cell rebuilt after
    its ring wrapped keeps a stale block.  The port matches the JAX package,
    not the dense pass: both rasters differ from their dense pass in the
    same sub-cells.  The step's map sequence, driven directly: cell A gets
    3 points in scans 0 and 1 (each build rotates its 2-slot ring, the
    second wraps it), none in scan 2, whose rebuild of A (last scan's ids)
    evicts scan 0's points and moves A's mean."""
    jm, tm = jcfg.MapConfig(**R1_MAP), tcfg.MapConfig(**R1_MAP)
    rs = np.random.RandomState(5)
    a = [3.3, -2.6]  # cell A
    other = rs.uniform(-15, 15, (3, 2))  # a cluster per scan elsewhere
    scans = []
    for k in range(3):
        pts = [other[k] + rs.normal(0, 0.3, (5, 2))]
        if k < 2:
            pts.append(np.float32(a) + rs.uniform(-0.45, 0.45, (3, 2)))
        pts = np.concatenate(pts).astype(np.float32)
        scans.append(np.concatenate([pts, np.full((8 - len(pts), 2), 99.0)]).astype(np.float32))
    valid = lambda pts: np.abs(pts).max(axis=1) < 90
    js, ts = jmap.init_map(jm), tmap.init_map(tm, device="cpu")
    jg, tg = jocc.init_og(jm, JOG), tocc.init_og(tm, TOG, "cpu")
    prev = np.full(8, tm.num_cells, np.int32)
    for pts in scans:
        v = valid(pts)
        idx, inb = tgeo.cell_index(torch.from_numpy(pts), size_m=tm.size_m,
                                   cell_side_m=tm.cell_side_m, cells_per_side=tm.cells_per_side)
        ids = torch.where(torch.from_numpy(v) & inb, idx, tm.num_cells).to(torch.int32)
        both = np.concatenate([ids.numpy(), prev])
        js = _jbuild_touched(_jadd_points(js, jm, pts, v), jm, jnp.asarray(both))
        jg = _jog_incremental(jg, js, jm, JOG, jnp.asarray(ids.numpy()))
        tmap.build_touched(tmap.add_points(ts, tm, torch.from_numpy(pts), torch.from_numpy(v)),
                           tm, torch.from_numpy(both))
        tg = tocc.og_update_incremental(tg, ts, tm, TOG, ids)
        prev = ids.numpy()
    _assert_rasters_close(tg, jg, "R1 incremental raster")
    tdense = tocc.og_update(tocc.init_og(tm, TOG, "cpu"), ts, tm, TOG)
    jdense = _jog_update(jocc.init_og(jm, JOG), js, jm, JOG)
    _assert_rasters_close(tdense, jdense, "R1 dense pass")
    t_stale = tg.og.numpy() != tdense.og.numpy()
    j_stale = np.asarray(jg.og) != np.asarray(jdense.og)
    print(f"R1: {int(t_stale.sum())} stale sub-cells in the port, {int(j_stale.sum())} in JAX")
    assert t_stale.sum() > 0, "no stale block: the run does not test R1"
    np.testing.assert_array_equal(t_stale, j_stale)
    # Only A's block is stale.
    ys, xs = np.nonzero(t_stale)
    ax, ay = ((np.float32(a) + 20.0) // 1.0).astype(int)
    assert (xs // 10 == ax).all() and (ys // 10 == ay).all()


@pytest.mark.gpu
def test_incremental_update_adds_no_sync_on_gpu():
    """The incremental update on the card under sync debug mode "error" (any
    host synchronization raises), then held to the same update on the CPU:
    the raster within 1 unit (exp's ulps differ), the bounds equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    maps = {d: tmap.init_map(TMAP, device=d) for d in ("cpu", dev)}
    grids = {d: tocc.init_og(TMAP, TOG, d) for d in ("cpu", dev)}
    for pts, valid in _clusters(7, 4):
        ids = _ids(pts, valid)
        for d in ("cpu", dev):
            tmap.build(tmap.add_points(maps[d], TMAP, torch.from_numpy(pts).to(d),
                                       torch.from_numpy(valid).to(d)), TMAP)
        torch.cuda.synchronize()
        ids_dev = ids.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            grids[dev] = tocc.og_update_incremental(grids[dev], maps[dev], TMAP, TOG, ids_dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        grids["cpu"] = tocc.og_update_incremental(grids["cpu"], maps["cpu"], TMAP, TOG, ids)
    got, want = grids[dev].og.cpu().numpy().astype(int), grids["cpu"].og.numpy().astype(int)
    assert np.abs(got - want).max() <= 1 and int(np.count_nonzero(want)) > 0
    for name in BOUNDS:
        assert int(getattr(grids[dev], name)) == int(getattr(grids["cpu"], name)), name
