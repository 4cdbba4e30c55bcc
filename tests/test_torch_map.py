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


def test_sparse_ring_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tmap.init_map(dataclasses.replace(TCFG, ring_rows=16), device="cpu")
