"""PyTorch port of the NDT map against the JAX package, on the CPU.

add_points -> build_touched -> snapshot over several scans, with a window
small enough that the ring rotates and wraps.  PyTorch's ``index_add_`` and
XLA's scatter both add in index order on the CPU, and the build is the same
elementwise arithmetic, so every statistic must match bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpso_slam_tpu import config as jcfg
from ndtpso_slam_tpu.models import cost as jcost
from ndtpso_slam_tpu.models import ndt_map as jmap
from ndtpso_slam_tpu.ops import geometry as jgeo

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap

JCFG = jcfg.MapConfig(size_m=16.0, cell_side_m=1.0, window_slots=4, slot_capacity=5)
TCFG = tcfg.MapConfig(size_m=16.0, cell_side_m=1.0, window_slots=4, slot_capacity=5)
FIELDS = [f.name for f in dataclasses.fields(tmap.NdtMapState)]


def _scans(seed, n_rounds, n_pts=60):
    """Clustered points (so cells overflow their slot and rotate), a few on
    and just outside the frame border, ~10% invalid."""
    rs = np.random.RandomState(seed)
    for _ in range(n_rounds):
        centers = rs.uniform(-6.5, 6.5, (3, 2))
        pts = centers[rs.randint(0, 3, n_pts)] + rs.normal(0, 0.3, (n_pts, 2))
        pts[:3] = [[8.0, 0.0], [-8.0, 1.0], [7.99, -7.99]]
        yield pts.astype(np.float32), rs.rand(n_pts) > 0.1


def _ids_jax(pts, valid):
    idx, inb = jgeo.cell_index(jnp.asarray(pts), size_m=JCFG.size_m,
                               cell_side_m=JCFG.cell_side_m,
                               cells_per_side=JCFG.cells_per_side)
    return jnp.where(jnp.asarray(valid) & inb, idx, JCFG.num_cells)


def _assert_state_equal(jstate, tstate):
    for name in FIELDS:
        j = np.asarray(getattr(jstate, name))
        t = getattr(tstate, name).numpy()
        if t.ndim and name not in ("ring_map",):
            t = t[:-1]  # the port's spare scatter row
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_build_touched_snapshot_bitwise(seed):
    js = jmap.init_map(JCFG)
    ts = tmap.init_map(TCFG, device="cpu")
    n = 60
    jprev = jnp.full((n,), JCFG.num_cells, jnp.int32)
    tprev = torch.full((n,), TCFG.num_cells, dtype=torch.int32)
    for pts, valid in _scans(seed, 12, n):
        jids = _ids_jax(pts, valid)
        tids = torch.from_numpy(np.array(jids)).to(torch.int32)
        js = jmap.add_points(js, JCFG, jnp.asarray(pts), jnp.asarray(valid))
        js = jmap.build_touched(js, JCFG, jnp.concatenate([jids, jprev]))
        tmap.add_points(ts, TCFG, torch.from_numpy(pts), torch.from_numpy(valid))
        tmap.build_touched(ts, TCFG, torch.cat([tids, tprev]))
        jprev, tprev = jids, tids
    _assert_state_equal(js, ts)
    jsnap, tsnap = jmap.snapshot(js, JCFG), tmap.snapshot(ts, TCFG)
    np.testing.assert_array_equal(tsnap.mean.numpy(), np.asarray(jsnap.mean))
    np.testing.assert_array_equal(tsnap.inv_cov.numpy(), np.asarray(jsnap.inv_cov))
    np.testing.assert_array_equal(tsnap.built.numpy(), np.asarray(jsnap.built))
    np.testing.assert_array_equal(
        tcost.snapshot_table(tsnap).numpy(), np.asarray(jcost.snapshot_table(jsnap))
    )
    assert tsnap.built.any()
    assert int(ts.rot_count.max()) >= 1


def test_ring_wraps_bitwise():
    """One cell hammered past its capacity every round, for twice as many
    rounds as the window has slots: the ring rotates every round and wraps."""
    rs = np.random.RandomState(2)
    js = jmap.init_map(JCFG)
    ts = tmap.init_map(TCFG, device="cpu")
    n_rounds = 2 * JCFG.window_slots
    for r in range(n_rounds):
        pts = (np.float32([3.3, 3.3]) + rs.normal(
            0.1 * r / n_rounds, 0.12, (JCFG.slot_capacity + 3, 2))).astype(np.float32)
        valid = np.ones(len(pts), bool)
        js = jmap.build(jmap.add_points(js, JCFG, jnp.asarray(pts), jnp.asarray(valid)), JCFG)
        tmap.build(tmap.add_points(ts, TCFG, torch.from_numpy(pts), torch.from_numpy(valid)), TCFG)
    _assert_state_equal(js, ts)
    assert int(ts.rot_count.max()) >= TCFG.window_slots
    np.testing.assert_array_equal(
        ts.slot_idx.numpy()[:-1], ts.rot_count.numpy()[:-1] % TCFG.window_slots
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_dense_build_equals_build_touched(seed):
    """The port's dense build and its touched build (this scan's and the last
    scan's cells) give the same state; the dense one also matches the JAX
    dense build bit for bit."""
    dense = tmap.init_map(TCFG, device="cpu")
    touched = tmap.init_map(TCFG, device="cpu")
    js = jmap.init_map(JCFG)
    prev = torch.full((60,), TCFG.num_cells, dtype=torch.int32)
    for pts, valid in _scans(seed, 10):
        tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
        ids = torch.from_numpy(np.array(_ids_jax(pts, valid))).to(torch.int32)
        tmap.build(tmap.add_points(dense, TCFG, tp, tv), TCFG)
        tmap.build_touched(tmap.add_points(touched, TCFG, tp, tv), TCFG, torch.cat([ids, prev]))
        js = jmap.build(jmap.add_points(js, JCFG, jnp.asarray(pts), jnp.asarray(valid)), JCFG)
        prev = ids
    for name in FIELDS:
        d, t = getattr(dense, name), getattr(touched, name)
        if d.ndim:
            d, t = d[:-1], t[:-1]
        np.testing.assert_array_equal(t.numpy(), d.numpy(), err_msg=name)
    _assert_state_equal(js, dense)


def test_out_of_frame_points_dropped_and_flags():
    ts = tmap.init_map(TCFG, device="cpu")
    pts = torch.tensor([[100.0, 0.0], [0.0, -100.0], [7.9, 7.9], [8.0, 0.0], [0.5, 0.5]])
    valid = torch.tensor([True, True, True, True, False])
    tmap.add_points(ts, TCFG, pts, valid)
    real = ts.cur_count[:-1]
    assert int(real.sum()) == 1  # only (7.9, 7.9)
    assert int(ts.created[:-1].sum()) == 1
    # A cell needs more than 2 points in its window to build.
    for n in (2, 1):
        tmap.add_points(ts, TCFG, torch.full((n, 2), -3.3), torch.ones(n, dtype=torch.bool))
        tmap.build(ts, TCFG)
        cell = 4 + 16 * 4
        assert bool(ts.built[cell]) == (n == 1)
    snap = tmap.snapshot(ts, TCFG)
    assert snap.mean.shape == (TCFG.num_cells, 2) and snap.built.shape == (TCFG.num_cells,)


def test_cell_centers_match():
    j = np.asarray(jmap.cell_centers(JCFG))
    t = tmap.cell_centers(TCFG, device="cpu").numpy()
    np.testing.assert_array_equal(t, j)


# ------------------------------------------------------------ sparse ring


def _sparse(cfg, rows):
    return dataclasses.replace(cfg, ring_rows=rows)


def _touched_rounds(tcfg_, jcfg_=None, n_rounds=12, seed=7):
    """tests/test_map.py's ingest -> build_touched rounds (out-of-frame
    points, invalid beams, rotations), on the port and, given ``jcfg_``, on
    the JAX package.  Returns (port state, JAX state or None)."""
    rs = np.random.RandomState(seed)
    ts = tmap.init_map(tcfg_, device="cpu")
    js = jmap.init_map(jcfg_) if jcfg_ is not None else None
    prev = np.full(40, tcfg_.num_cells, np.int32)
    for _ in range(n_rounds):
        centers = rs.uniform(-6, 6, (3, 2))
        pts = (centers[rs.randint(0, 3, 40)] + rs.normal(0, 0.3, (40, 2))).astype(np.float32)
        pts[:4] += 40.0
        valid = rs.rand(40) > 0.15
        ids = np.asarray(_ids_jax(pts, valid)).astype(np.int32)
        both = np.concatenate([ids, prev])
        tmap.build_touched(tmap.add_points(ts, tcfg_, torch.from_numpy(pts),
                                           torch.from_numpy(valid)),
                           tcfg_, torch.from_numpy(both))
        if js is not None:
            js = jmap.build_touched(jmap.add_points(js, jcfg_, jnp.asarray(pts),
                                                    jnp.asarray(valid)),
                                    jcfg_, jnp.asarray(both))
        prev = ids
    return ts, js


PER_CELL = ("mean_c", "inv_cov", "built", "created", "g_sum", "g_count", "g_cov",
            "slot_idx", "rot_count", "cur_sum", "cur_count", "cur_m2")
SLOTS = ("slot_sum", "slot_count", "slot_cov")


def test_sparse_build_touched_equals_dense():
    """Mirror of tests/test_map.py::test_sparse_ring_matches_dense_ring: a
    sparse ring (R = 160, more than the cells touched) gives every per-cell
    field bit for bit as the dense ring, and each touched cell's ring row
    through ring_map holds the dense ring's row."""
    dense, _ = _touched_rounds(TCFG)
    sparse, _ = _touched_rounds(_sparse(TCFG, 160))
    for name in PER_CELL:
        np.testing.assert_array_equal(getattr(sparse, name)[:-1].numpy(),
                                      getattr(dense, name)[:-1].numpy(), err_msg=name)
    rmap = sparse.ring_map[:-1].numpy()
    used = int(sparse.ring_used)
    assert int(sparse.ring_overflow) == 0 and used == (rmap >= 0).sum() > 0
    assert sorted(rmap[rmap >= 0]) == list(range(used))
    touched = dense.slot_count[:-1].numpy().sum(axis=1) > 0
    assert (rmap[touched] >= 0).all()
    for name in SLOTS:
        np.testing.assert_array_equal(getattr(sparse, name)[rmap[touched]].numpy(),
                                      getattr(dense, name)[:-1][touched].numpy(), err_msg=name)
    assert getattr(sparse, "slot_sum").shape[0] == 161


def test_sparse_ring_equals_dense_ring_over_a_wrap():
    """One cell hammered past its capacity for twice the window's slots (the
    ring rotates every round and wraps), built through build_touched with
    this round's and last round's ids: sparse (R = 4) equals dense."""
    rs = np.random.RandomState(2)
    dense = tmap.init_map(TCFG, device="cpu")
    sparse_cfg = _sparse(TCFG, 4)
    sparse = tmap.init_map(sparse_cfg, device="cpu")
    prev = torch.full((TCFG.slot_capacity + 3,), TCFG.num_cells, dtype=torch.int32)
    n_rounds = 2 * TCFG.window_slots
    for r in range(n_rounds):
        pts = (np.float32([3.3, 3.3]) + rs.normal(
            0.1 * r / n_rounds, 0.12, (TCFG.slot_capacity + 3, 2))).astype(np.float32)
        valid = np.ones(len(pts), bool)
        ids = torch.from_numpy(np.asarray(_ids_jax(pts, valid)).astype(np.int32))
        for st, cfg in ((dense, TCFG), (sparse, sparse_cfg)):
            tmap.add_points(st, cfg, torch.from_numpy(pts), torch.from_numpy(valid))
            tmap.build_touched(st, cfg, torch.cat([ids, prev]))
        prev = ids
    assert int(sparse.rot_count.max()) >= TCFG.window_slots
    for name in PER_CELL:
        np.testing.assert_array_equal(getattr(sparse, name).numpy(),
                                      getattr(dense, name).numpy(), err_msg=name)
    rmap = sparse.ring_map[:-1].numpy()
    cells = np.flatnonzero(rmap >= 0)
    for name in SLOTS:
        np.testing.assert_array_equal(getattr(sparse, name)[rmap[cells]].numpy(),
                                      getattr(dense, name)[cells].numpy(), err_msg=name)


def test_sparse_ring_overflow_graceful_counted_once_per_cell():
    """Mirror of tests/test_map.py::test_sparse_ring_overflow_is_graceful_and_observable:
    R = 2 rows; the assigned cells equal the dense ring's, the overflowed
    cells never build, and ring_overflow counts distinct cells: building the
    same touched set again does not raise it."""
    scfg = _sparse(TCFG, 2)
    dense, _ = _touched_rounds(TCFG)
    sparse, _ = _touched_rounds(scfg)
    assert int(sparse.ring_overflow) > 0 and int(sparse.ring_used) == 2
    rmap = sparse.ring_map[:-1].numpy()
    has_row = rmap >= 0
    for name in ("mean_c", "g_sum", "g_count", "slot_idx"):
        np.testing.assert_array_equal(getattr(sparse, name)[:-1].numpy()[has_row],
                                      getattr(dense, name)[:-1].numpy()[has_row], err_msg=name)
    touched = dense.slot_count[:-1].numpy().sum(1) > 0
    overflowed = ~has_row & touched
    assert overflowed.any() and not sparse.built[:-1].numpy()[overflowed].any()
    assert int(sparse.ring_overflow) == int((rmap == -2).sum())
    before = int(sparse.ring_overflow)
    tmap.build_touched(sparse, scfg, torch.from_numpy(np.flatnonzero(touched)).to(torch.int32))
    assert int(sparse.ring_overflow) == before


@pytest.mark.parametrize("rows", [160, 3])
def test_sparse_map_matches_jax_sparse_bitwise(rows):
    """The port's sparse ring against the JAX package's sparse ring on the
    same rounds, with room to spare and overflowing: every field bit for
    bit, ring_map, ring_used and ring_overflow included."""
    ts, js = _touched_rounds(_sparse(TCFG, rows), _sparse(JCFG, rows))
    for name in FIELDS:
        t = getattr(ts, name).numpy()
        if t.ndim:
            t = t[:-1]  # the spare rows
        np.testing.assert_array_equal(t, np.asarray(getattr(js, name)), err_msg=name)
    assert (int(ts.ring_overflow) > 0) == (rows == 3)


def test_dense_build_rejects_sparse_config():
    scfg = _sparse(TCFG, 8)
    with pytest.raises(ValueError, match="build_touched"):
        tmap.build(tmap.init_map(scfg, device="cpu"), scfg)


def test_reset_gives_a_fresh_map():
    scfg = _sparse(TCFG, 160)
    st, _ = _touched_rounds(scfg, n_rounds=3)
    tmap.reset(st)
    fresh = tmap.init_map(scfg, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(st, name).numpy(), getattr(fresh, name).numpy(),
                                      err_msg=name)
