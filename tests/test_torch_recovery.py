"""The port's tracking-loss recovery (models/slam.py, RecoveryConfig) against
the JAX package, on the CPU: the inflated snapshot, the window binder, the
relocalization grid and its non-max suppression, and slam_step with recovery
on (mirrors of tests/test_recovery.py, and the kidnap workload step by step
beside the JAX step).

Tolerances, with their reasons:

* smooth_snapshot and the window binder: bit for bit (the same float32
  operations in the same order; the JAX one-hot matmul selects exactly the
  row the port gathers);
* the relocalization grid: the port computes ``jnp.linspace`` as XLA folds
  it for constant arguments, bit for bit; XLA's compiled grid inside a
  jitted step contracts some products into fused multiply-adds, so it
  differs from that by at most one ulp per entry (ROADMAP §3);
* _nms_top_k: bit for bit on identical costs;
* the kidnap workload: per-scan poses 5e-4 (tests/test_torch_slam.py's
  trajectory tolerance), recoveries equal.  The step-by-step mirrors feed
  both packages the same scan points: this workload's relocalization lands
  in another basin under perturbations as small as the maps' float32 sum
  order, in the JAX package too (ROADMAP §3, R5).  Each package's own run
  on the scans it loads is compared at OWN_KEY, where both relocalize: the
  8-scan maps (integer fields equal, sums within 1e-5 of each field's
  largest magnitude) and the poses through the relocalization.

The ``gpu`` tests (stages 2-3 through the refine's kernel and the fused
scoring kernel; a recovery-off step under sync debug mode) skip here.  The
GPU machine has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_recovery.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.io import synthetic as tsynth
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.ops import reloc_step as treloc
from ndtpso_slam_tpu_torch.ops import rng as trng
from ndtpso_slam_tpu_torch.ops import score as tscore
from ndtpso_slam_tpu_torch.utils.state import slam_state_from_numpy, slam_state_to_numpy

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import cost as jcost
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.models import scan as jscan
    from ndtpso_slam_tpu.models import slam as jslam
    from ndtpso_slam_tpu.ops import rng as jrng
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")

N_BEAMS = 360
# The kidnap workload relocalizes near the truth for some keys only, in the
# JAX package as well (ROADMAP R5, tests/recovery_keys.py: of the keys
# (21, 9), (1, 2), (3, 4) and (7, 8), the JAX step lands within 0.3 m at its
# own test's (21, 9) alone, and accepts a pose 3-5 m off at the others).
# On the JAX package's scans the port's step lands where the JAX step does
# at this key.
KEY = (1, 2)
# tests/test_recovery.py's key, where the JAX step relocalizes.
JAX_TEST_KEY = (21, 9)
# A key where the JAX package's own run and the port's own run (each on the
# scans it loads) both relocalize: of the 54 keys of
# ``tests/recovery_keys.py --wide`` the JAX package's own run relocalizes at
# (21, 9) and (123, 124), the port's own run at (105, 106) and (123, 124).
OWN_KEY = (123, 124)
TRAJ_ATOL = 5e-4
SMALL_MAP = dict(size_m=32.0, cell_side_m=1.0, window_slots=4)


def _cfg(m, recovery_on, cost_mode="exact"):
    """tests/test_recovery.py's configuration."""
    return m.SlamConfig(
        pso=m.PSOConfig(iterations=30, population=50),
        map=m.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=8),
        scan=m.ScanConfig(max_beams=N_BEAMS),
        og=m.OccupancyGridConfig(enabled=False),
        recovery=m.RecoveryConfig(enabled=recovery_on, fitness_threshold=0.2,
                                  spread=(3.0, 3.0, np.pi), grid=(24, 24, 16)),
        cost_mode=cost_mode,
    )


def _ranges(segs, pose):
    return tsynth.raycast(segs, np.asarray(pose, np.float64), N_BEAMS, -np.pi,
                          2 * np.pi / N_BEAMS, 30.0).astype(np.float32)


def kidnap_workload():
    """tests/test_recovery.py's kidnap: 8 crawling scans, then the robot
    teleported 3 m away inside the mapped region.  Returns (true poses
    [10, 3], ranges [10, 360])."""
    segs = tsynth.make_world(seed=11, size=40.0, n_boxes=6)
    path = [(0.06 * i, 0.03 * i, 0.01 * i) for i in range(8)]
    kidnap = (2.4, -1.6, 0.5)
    poses = np.asarray(path + [kidnap, (kidnap[0] + 0.05, kidnap[1], kidnap[2])])
    return poses, np.stack([_ranges(segs, p) for p in poses])


def _load(ranges, cfg):
    return tscan.load_laser(ranges, -np.pi, 2 * np.pi / N_BEAMS, 30.0, cfg.scan, cfg.map,
                            device="cpu")


def _run(cfg, init_pose, scans, key=KEY):
    state = tslam.init_slam(cfg, tuple(init_pose), device="cpu")
    out = []
    for i, sc in enumerate(scans):
        state, pose, _ = tslam.slam_step(state, sc, trng.derive_key(key, i), cfg)
        out.append(pose.numpy().astype(np.float64))
    return state, np.stack(out)


def _xy_err(est, true):
    return np.hypot(est[:, 0] - true[:, 0], est[:, 1] - true[:, 1])


# ------------------------------------------ mirrors of tests/test_recovery.py


def test_kidnapped_robot_relocalizes():
    """tests/test_recovery.py's kidnap, the port alone on the scans it loads,
    from mapping to relocalization, at a key where the JAX package's own run
    relocalizes too (OWN_KEY)."""
    cfg = _cfg(tcfg, True)
    poses, ranges = kidnap_workload()
    state, est = _run(cfg, poses[0], [_load(r, cfg) for r in ranges], OWN_KEY)
    err = _xy_err(est, poses)
    assert state.recoveries >= 1, "kidnap did not trigger recovery"
    assert err[-2] < 0.3, f"relocalization missed: err {err[-2]:.3f} m"
    assert err[-1] < 0.3, f"post-recovery tracking lost: err {err[-1]:.3f} m"
    # The jump is not robot motion: recovery resets pose_diff.
    assert float(state.align.pose_diff.abs().max()) < 0.5


# The accumulated float fields of the map, held within 1e-5 of each field's
# largest magnitude (float32 sums of a few hundred terms in another order).
# inv_cov is left out: an inverse of a near-singular covariance multiplies
# those last bits by its condition number (up to 2.3 relative here).
MAP_SUM_FIELDS = ("cur_sum", "cur_m2", "g_sum", "g_cov", "slot_sum", "slot_cov", "mean_c")


@needs_jax
def test_kidnap_own_run_lands_with_jax():
    """Both packages on the scans each loads itself, at OWN_KEY: the 8-scan
    maps equal in every integer field and within sum order in the
    accumulated ones, the poses through the relocalization (scans 0-8)
    within 5e-4, the same recoveries, and both relocalized.  The scan after
    it is held to the 0.3 m gate only: the two runs part there by 1.7e-3,
    the sum-order difference of the relocalized map grown by one PSO solve
    (ROADMAP R5)."""
    cfg, jc = _cfg(tcfg, True), _cfg(jcfg, True)
    poses, ranges = kidnap_workload()
    state = tslam.init_slam(cfg, tuple(poses[0]), device="cpu")
    jstate = jslam.init_slam(jc, tuple(poses[0]))
    est, jest = [], []
    for i, r in enumerate(ranges):
        state, pose, _ = tslam.slam_step(state, _load(r, cfg), trng.derive_key(OWN_KEY, i), cfg)
        sc = jscan.load_laser(r, -np.pi, 2 * np.pi / N_BEAMS, 30.0, jc.scan, jc.map)
        key = jrng.threefry2x32((np.uint32(OWN_KEY[0]), np.uint32(OWN_KEY[1])), np.uint32(i),
                                np.uint32(0))
        jstate, jpose, _ = jslam.slam_step(jstate, sc, key, jc)
        est.append(pose.numpy().astype(np.float64))
        jest.append(np.asarray(jpose, np.float64))
        if i == 7:
            mine, ref = slam_state_to_numpy(state), _jax_state_to_numpy(jstate)
            for name in ref:
                if not name.startswith("map."):
                    continue
                want, got = np.asarray(ref[name]), np.asarray(mine[name])
                if want.dtype.kind in "biu":
                    np.testing.assert_array_equal(got, want, err_msg=name)
                elif name[4:] in MAP_SUM_FIELDS:
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=1e-5 * np.abs(want).max(), err_msg=name)
    est, jest = np.stack(est), np.stack(jest)
    np.testing.assert_allclose(est[:9], jest[:9], atol=TRAJ_ATOL)
    assert state.recoveries == int(jstate.recoveries) == 1
    assert _xy_err(est, poses)[-2:].max() < 0.3 and _xy_err(jest, poses)[-2:].max() < 0.3


@needs_jax
def test_kidnap_from_jax_state_relocalizes():
    """tests/test_recovery.py's kidnap at its own key (21, 9), the port's
    step continuing the JAX package's state after the 8 crawling scans with
    the scans the port loads.  The port's own run lands 3.4 m off at this key,
    in a basin whose exact cost is lower than the truth's: which basin the
    relocalization finds turns on the map's last bits (ROADMAP R5).  From the
    JAX package's map the port lands where the JAX step lands."""
    cfg, jc = _cfg(tcfg, True), _cfg(jcfg, True)
    poses, ranges = kidnap_workload()
    scans = [_load(r, cfg) for r in ranges]
    _, est = _run(cfg, poses[0], scans[:8], JAX_TEST_KEY)
    jstate = jslam.init_slam(jc, tuple(poses[0]))
    jest = []
    for i, r in enumerate(ranges[:8]):
        sc = jscan.load_laser(r, -np.pi, 2 * np.pi / N_BEAMS, 30.0, jc.scan, jc.map)
        key = jrng.threefry2x32((np.uint32(JAX_TEST_KEY[0]), np.uint32(JAX_TEST_KEY[1])),
                                np.uint32(i), np.uint32(0))
        jstate, pose, _ = jslam.slam_step(jstate, sc, key, jc)
        jest.append(np.asarray(pose, np.float64))
    np.testing.assert_allclose(est, np.stack(jest), atol=TRAJ_ATOL)
    state = slam_state_from_numpy(_jax_state_to_numpy(jstate), cfg, device="cpu")
    for i in (8, 9):
        state, pose, _ = tslam.slam_step(state, scans[i], trng.derive_key(JAX_TEST_KEY, i), cfg)
        est = np.concatenate([est, pose.numpy().astype(np.float64)[None]])
    err = _xy_err(est, poses)
    assert state.recoveries >= 1, "kidnap did not trigger recovery"
    assert err[-2] < 0.3, f"relocalization missed: err {err[-2]:.3f} m"
    assert err[-1] < 0.3, f"post-recovery tracking lost: err {err[-1]:.3f} m"


def test_without_recovery_kidnap_loses_tracking():
    cfg = _cfg(tcfg, False)
    poses, ranges = kidnap_workload()
    state, est = _run(cfg, poses[0], [_load(r, cfg) for r in ranges])
    assert _xy_err(est, poses)[-1] > 1.0
    assert state.recoveries == 0


def test_degraded_scan_dead_reckons_and_skips_ingestion():
    cfg = _cfg(tcfg, True)
    segs = tsynth.make_world(seed=12, size=40.0, n_boxes=6)
    poses = [(0.1 * i, 0.05 * i, 0.0) for i in range(6)]
    scans = [_load(_ranges(segs, p), cfg) for p in poses]
    dead = _load(np.zeros(N_BEAMS, np.float32), cfg)  # every beam fails the epsilon filter
    assert not bool(dead.valid.any())
    state = tslam.init_slam(cfg, poses[0], device="cpu")
    for i in range(4):
        state, _, _ = tslam.slam_step(state, scans[i], trng.derive_key(KEY, i), cfg)
    diff_before, pose_before = state.align.pose_diff.clone(), state.pose.clone()
    counts = lambda s: int(s.map.g_count.sum()) + int(s.map.cur_count.sum())
    counts_before = counts(state)
    state, pose, _ = tslam.slam_step(state, dead, trng.derive_key(KEY, 4), cfg)
    np.testing.assert_allclose(pose.numpy(), (pose_before + diff_before).numpy(), atol=1e-6)
    np.testing.assert_allclose(state.align.pose_diff.numpy(), diff_before.numpy(), atol=1e-6)
    assert counts(state) == counts_before, "dropout scan was ingested"
    state, pose, _ = tslam.slam_step(state, scans[5], trng.derive_key(KEY, 5), cfg)
    x, y = pose[:2].tolist()
    assert np.hypot(x - poses[5][0], y - poses[5][1]) < 0.15


def test_recovery_is_noop_on_healthy_run():
    """No tracking loss: the pose stream with recovery on is the one with it
    off, bit for bit."""
    log = tsynth.make_log(seed=13, n_scans=10, n_beams=N_BEAMS, world_size=40.0, dt=0.1)
    on, off = _cfg(tcfg, True), _cfg(tcfg, False)
    scans = [tscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max, on.scan,
                              on.map, device="cpu") for r in log.ranges]
    state_on, est_on = _run(on, log.poses[0], scans)
    _, est_off = _run(off, log.poses[0], scans)
    np.testing.assert_array_equal(est_on, est_off)
    assert state_on.recoveries == 0
    assert float(state_on.fitness) > 0.3


# --------------------------------------------------- the kidnap beside JAX


@pytest.fixture(scope="module")
def jax_kidnap():
    """The JAX step over the kidnap workload (recovery on, KEY), on the scans
    the JAX package loads; one compile."""
    cfg = _cfg(jcfg, True)
    poses, ranges = kidnap_workload()
    scans = [jscan.load_laser(r, -np.pi, 2 * np.pi / N_BEAMS, 30.0, cfg.scan, cfg.map)
             for r in ranges]
    state = jslam.init_slam(cfg, tuple(poses[0]))
    out, states = [], []
    for i, sc in enumerate(scans):
        key = jrng.threefry2x32((np.uint32(KEY[0]), np.uint32(KEY[1])), np.uint32(i), np.uint32(0))
        state, pose, _ = jslam.slam_step(state, sc, key, cfg)
        out.append(np.asarray(pose, np.float64))
        states.append(state)
    return dict(cfg=cfg, poses=poses, scans=scans, est=np.stack(out), states=states)


def _shared_scans(jk):
    return [tscan.Scan(points=torch.from_numpy(np.array(s.points)),
                       valid=torch.from_numpy(np.array(s.valid))) for s in jk["scans"]]


@needs_jax
def test_kidnap_steps_match_jax(jax_kidnap):
    """Per-scan poses within 5e-4 of the JAX step and the same number of
    accepted relocalizations, through the relocalization (stage 1 on the
    inflated map, both stages of swarms on the full-table binder)."""
    state, est = _run(_cfg(tcfg, True), jax_kidnap["poses"][0], _shared_scans(jax_kidnap))
    np.testing.assert_allclose(est, jax_kidnap["est"], atol=TRAJ_ATOL)
    jstate = jax_kidnap["states"][-1]
    assert state.recoveries == int(jstate.recoveries) == 1
    np.testing.assert_allclose(float(state.fitness), float(jstate.fitness), rtol=1e-4)


def _jax_state_to_numpy(state):
    out = {f"map.{f.name}": np.asarray(getattr(state.map, f.name))
           for f in dataclasses.fields(state.map)}
    for name in ("prev_pose", "pose_diff", "iter"):
        out[f"align.{name}"] = np.asarray(getattr(state.align, name))
    for name in ("pose", "step", "fitness", "recoveries", "prev_ids"):
        out[name] = np.asarray(getattr(state, name))
    return out


def _jax_state_from_numpy(arrays, cfg):
    st = jslam.init_slam(cfg)
    m = st.map.replace(**{f.name: jnp.asarray(arrays[f"map.{f.name}"])
                          for f in dataclasses.fields(st.map)})
    align = jslam.AlignState(**{n: jnp.asarray(arrays[f"align.{n}"])
                                for n in ("prev_pose", "pose_diff", "iter")})
    return st.replace(map=m, align=align, **{n: jnp.asarray(arrays[n]) for n in (
        "pose", "step", "fitness", "recoveries", "prev_ids")})


@needs_jax
def test_recovery_state_round_trips_both_ways(jax_kidnap):
    """recoveries and fitness of a recovery run carried through the state
    dict: the JAX state after the kidnap into the port and back unchanged;
    the port's state after the same run into the JAX package, which
    continues it."""
    tc, jc = _cfg(tcfg, True), jax_kidnap["cfg"]
    arrays = _jax_state_to_numpy(jax_kidnap["states"][-1])
    tstate = slam_state_from_numpy(arrays, tc, device="cpu")
    assert tstate.recoveries == 1 and float(tstate.fitness) == float(arrays["fitness"])
    back = slam_state_to_numpy(tstate)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    scans = _shared_scans(jax_kidnap)
    pstate, _ = _run(tc, jax_kidnap["poses"][0], scans[:9])
    parrays = slam_state_to_numpy(pstate)
    assert int(parrays["recoveries"]) == 1
    jstate = _jax_state_from_numpy(parrays, jc)
    assert int(jstate.recoveries) == 1 and float(jstate.fitness) == float(parrays["fitness"])
    key = jrng.threefry2x32((np.uint32(KEY[0]), np.uint32(KEY[1])), np.uint32(9), np.uint32(0))
    jstate, jpose, _ = jslam.slam_step(jstate, jax_kidnap["scans"][9], key, jc)
    pstate, ppose, _ = tslam.slam_step(pstate, scans[9], trng.derive_key(KEY, 9), tc)
    np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), atol=TRAJ_ATOL)
    assert int(jstate.recoveries) == pstate.recoveries == 1


# ------------------------------------------------ the supporting modules


@pytest.fixture(scope="module")
def small_map():
    """The rollout tests' ellipse map (port-built, bit-equal to JAX's on the
    CPU), with two degenerate cells: one whose inverse has det 0, one with
    det 1e-24."""
    mc = tcfg.MapConfig(**SMALL_MAP)
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))).astype(np.float32)
    state = tmap.init_map(mc, device="cpu")
    for _ in range(2):
        tmap.add_points(state, mc, torch.from_numpy(pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)),
                        torch.ones(200, dtype=torch.bool))
        tmap.build(state, mc)
    snap = tmap.snapshot(state, mc)
    built = np.flatnonzero(snap.built.numpy())
    inv_cov = snap.inv_cov.numpy().copy()
    inv_cov[built[0]] = [1.0, 1.0, 1.0]
    inv_cov[built[1]] = [1e-12, 0.0, 1e-12]
    return dict(mean=snap.mean.numpy(), inv_cov=inv_cov, built=snap.built.numpy(), pts=pts,
                degenerate=built[:2])


def _tsnap(m):
    return tmap.MapSnapshot(*(torch.from_numpy(m[k]) for k in ("mean", "inv_cov", "built")))


def _jsnap(m):
    return jmap.MapSnapshot(**{k: jnp.asarray(m[k]) for k in ("mean", "inv_cov", "built")})


@needs_jax
@pytest.mark.parametrize("sigma", [0.5, 0.1])
def test_smooth_snapshot_matches_jax(small_map, sigma):
    got = tmap.smooth_snapshot(_tsnap(small_map), sigma)
    want = jmap.smooth_snapshot(_jsnap(small_map), sigma)  # op by op
    np.testing.assert_array_equal(got.inv_cov.numpy(), np.asarray(want.inv_cov))
    np.testing.assert_array_equal(got.built.numpy(), np.asarray(want.built))
    np.testing.assert_array_equal(got.mean.numpy(), small_map["mean"])
    assert not got.built[small_map["degenerate"]].any() and int(got.built.sum()) > 10


@needs_jax
def test_window_binder_matches_jax(small_map):
    """A 12 x 12 window centred near the grid's corner (clipped on both
    axes), four binding poses: the origin, the window, and every point's
    mask equal the JAX binder's, and so does w, bit for bit at the unrotated
    binds; at a rotated bind PyTorch's and XLA's sin/cos of the angle differ
    in the last ulp, which moves w by up to 1.1e-6 relative (the cancelling
    terms of BᵀΛB).  Points outside the window score 0 and the rest equal
    the full-table binder's."""
    mc, ps = tcfg.MapConfig(**SMALL_MAP), 12
    jc = jcfg.MapConfig(**SMALL_MAP)
    w = mc.cells_per_side
    last = np.float32([13.0, -13.5, 0.3])
    binds = np.float32([[0.0, 0.0, 0.0], [0.7, -0.4, 0.0], [0.4, -0.3, 0.2], [-0.5, 0.2, -0.4]])
    pts = np.zeros((256, 2), np.float32)
    pts[:200] = small_map["pts"]
    valid = np.arange(256) < 200
    snap, tbl = _tsnap(small_map), tcost.snapshot_table(_tsnap(small_map))
    origin = tcost.window_origin(torch.from_numpy(last), ps, mc)
    patch = tcost.table_window(tbl, origin, ps, mc)
    got = tcost.bind_points_matmul_window(torch.from_numpy(binds), patch, origin, ps,
                                          torch.from_numpy(pts), torch.from_numpy(valid), mc)

    from ndtpso_slam_tpu.ops.geometry import cell_coords

    cx, cy, _ = cell_coords(jnp.asarray(last[:2]), size_m=jc.size_m, cell_side_m=jc.cell_side_m)
    ox, oy = jnp.clip(cx - ps // 2, 0, w - ps), jnp.clip(cy - ps // 2, 0, w - ps)
    assert (int(origin[0]), int(origin[1])) == (int(ox), int(oy)) == (w - ps, 0)
    jtbl = jcost.snapshot_table(_jsnap(small_map))
    jpatch = jax.lax.dynamic_slice(jtbl.reshape(w, w, 6), (oy, ox, 0), (ps, ps, 6)).reshape(ps * ps, 6)
    np.testing.assert_array_equal(patch.numpy(), np.asarray(jpatch))
    for b in range(len(binds)):
        want = jcost.bind_points_matmul_window(jnp.asarray(binds[b]), jpatch, (ox, oy), ps,
                                               jnp.asarray(pts), jnp.asarray(valid), jc)
        np.testing.assert_array_equal(got.mask[b].numpy(), np.asarray(want.mask))
        if binds[b, 2] == 0:
            np.testing.assert_array_equal(got.w[b].numpy(), np.asarray(want.w))
        else:
            np.testing.assert_allclose(got.w[b].numpy(), np.asarray(want.w), rtol=2e-6, atol=1e-6)
    full = tcost.bind_points_matmul(torch.from_numpy(binds), tbl, torch.from_numpy(pts),
                                    torch.from_numpy(valid), mc)
    inside = got.mask > 0
    assert 0 < int(inside.sum()) < int((full.mask > 0).sum())
    assert torch.equal(got.w[inside], full.w[inside])
    assert (got.w[~inside] == 0).all()


@needs_jax
@pytest.mark.parametrize("n,s", [(24, 3.0), (32, np.pi), (16, np.pi), (100, 7.0), (2, 1.0), (1, 1.0)])
def test_linspace_is_xla_folded_linspace(n, s):
    """The port's grid axis equals XLA's constant-folded jnp.linspace bit
    for bit."""
    want = jax.jit(lambda: jnp.linspace(-s, s, n, dtype=jnp.float32))()
    np.testing.assert_array_equal(tslam._linspace(s, n, torch.float32, "cpu").numpy(),
                                  np.asarray(want))


@needs_jax
@pytest.mark.parametrize("grid", [(24, 24, 16), (24, 24, 32)])
def test_reloc_grid_within_one_ulp_of_jax(grid):
    """Against the JAX grid compiled with a runtime pose (as inside the jitted
    step): every entry within one float32 ulp of its axis's extent
    (|last pose| + spread; measured: x and y equal, θ one ulp off in some
    entries), most entries equal."""
    rc = tcfg.RecoveryConfig(grid=grid)
    last = np.float32([0.42, 0.21, 0.07])
    want = np.asarray(jax.jit(lambda p: jslam._reloc_grid(p, jcfg.RecoveryConfig(grid=grid),
                                                          jnp.float32))(jnp.asarray(last)))
    got = tslam._reloc_grid(torch.from_numpy(last), rc, torch.float32).numpy()
    assert got.shape == want.shape == (int(np.prod(grid)), 3)
    extent = np.spacing((np.abs(last) + np.float32(rc.spread)).astype(np.float32))
    assert (np.abs(got - want) <= extent).all()
    assert (got == want).mean() > 0.8


@needs_jax
def test_nms_top_k_matches_jax_on_identical_costs():
    """Greedy picks with first-minimum ties and θ wrapping, on the same
    costs (exact ties, an inf): the same K poses, bit for bit."""
    rc = tcfg.RecoveryConfig(grid=(24, 24, 16))
    grid = tslam._reloc_grid(torch.tensor([0.4, 0.2, 3.0]), rc, torch.float32)
    rs = np.random.RandomState(3)
    costs = rs.uniform(-100, 0, grid.shape[0]).astype(np.float32).round(0)  # many ties
    costs[17] = np.inf
    radius = 1.5 * np.float32([6.0 / 23, 6.0 / 23, 2 * np.pi / 15])
    got = tslam._nms_top_k(grid, torch.from_numpy(costs), 8, torch.from_numpy(radius))
    want = jslam._nms_top_k(jnp.asarray(grid.numpy()), jnp.asarray(costs), 8, jnp.asarray(radius))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(r) for r in got.numpy().tolist()}) == 8


def test_relocalize_uses_the_window_below_the_grid_side(monkeypatch):
    """patch_cells smaller than the grid takes the window binder around the
    last pose; the event still relocalizes the kidnap (stage 1 on every
    beam: a 48-cell map is below the auto stride's threshold)."""
    calls = []
    real = tcost.bind_points_matmul_window
    monkeypatch.setattr(tcost, "bind_points_matmul_window",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    cfg = _cfg(tcfg, True)
    cfg = dataclasses.replace(cfg, recovery=dataclasses.replace(cfg.recovery, patch_cells=40))
    poses, ranges = kidnap_workload()
    state, est = _run(cfg, poses[0], [_load(r, cfg) for r in ranges])
    assert calls and set(calls) == {40}
    assert state.recoveries >= 1


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


# chip_smoke.py's rule for the scoring kernel: its error against the float64
# value of the same sum may be at most SCORE_SLACK times the plain float32
# version's, or SCORE_ATOL.
SCORE_SLACK = 2.0
SCORE_ATOL = 1e-4


def _before_kidnap():
    """The port's state after the 8 crawling scans, the kidnapped scan, and
    the relocalization's hypotheses (stage 1, on the CPU)."""
    cfg = _cfg(tcfg, True)
    poses, ranges = kidnap_workload()
    scans = [_load(r, cfg) for r in ranges]
    state, _ = _run(cfg, poses[0], scans[:8])
    snap = tmap.snapshot(state.map, cfg.map)
    seen = []
    real = tslam._refine_hypotheses
    tslam._refine_hypotheses = lambda *a: seen.append(a[4].clone()) or real(*a)
    try:
        tslam._relocalize(trng.derive_key(KEY, 8), snap, scans[8], state.pose, state.pose, cfg)
    finally:
        tslam._refine_hypotheses = real
    return cfg, state, snap, scans[8], seen[0]


@pytest.mark.gpu
def test_refine_hypotheses_through_k3_on_gpu(cuda_device):
    """Stages 2-3 on the card score through the fused scoring kernel (one
    launch per cost evaluation, 2 x (I + 2)), each after a launch of the
    refine's kernel (ops/reloc_step.py); each K3 launch is held to the plain
    version on its operands by the float64 rule; the winner lands where the
    CPU path's does, at the frozen-solve tolerance."""
    cfg, state, snap, scan, hypo = _before_kidnap()
    want_pose, want_cost = tslam._refine_hypotheses(trng.derive_key(KEY, 8), snap, scan,
                                                    state.pose, hypo, cfg)
    to = lambda t: t.to(cuda_device)
    gsnap = tmap.MapSnapshot(to(snap.mean), to(snap.inv_cov), to(snap.built))
    gscan = tscan.Scan(points=to(scan.points), valid=to(scan.valid))
    seen, real = [], treloc.fused_bound_scores

    def recording(*ops):
        seen.append(tuple(t.clone() for t in ops))
        return real(*ops)

    before = tscore.fused_bound_scores.LAUNCHES
    before_reloc = treloc.reloc_step.LAUNCHES
    treloc.fused_bound_scores = recording
    try:
        pose, cost = tslam._refine_hypotheses(trng.derive_key(KEY, 8), gsnap, gscan,
                                              to(state.pose), to(hypo), cfg)
        torch.cuda.synchronize()
    finally:
        treloc.fused_bound_scores = real
    evals = 2 * (cfg.recovery.pso.iterations + 2)
    assert tscore.fused_bound_scores.LAUNCHES == before + evals == before + len(seen)
    assert treloc.reloc_step.LAUNCHES == before_reloc + evals
    for ops in seen:
        got = tscore.fused_bound_scores(*ops)
        plain = tscore.fused_bound_scores_reference(*ops)
        exact = tscore.fused_bound_scores_reference(*(t.double() for t in ops))
        err_k = (got.double() - exact).abs().max().item()
        err_p = (plain.double() - exact).abs().max().item()
        assert err_k <= max(SCORE_SLACK * err_p, SCORE_ATOL), (err_k, err_p)
    np.testing.assert_allclose(pose.cpu().numpy(), want_pose.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_recovery_off_step_adds_no_sync_on_gpu(cuda_device):
    """A main-path step (rollout_local, recovery off) after the cold start
    under sync debug mode "error": no host synchronization."""
    cfg = dataclasses.replace(_cfg(tcfg, False), cost_mode="rollout_local")
    poses, ranges = kidnap_workload()
    scans = [tscan.load_laser(r, -np.pi, 2 * np.pi / N_BEAMS, 30.0, cfg.scan, cfg.map,
                              device=cuda_device) for r in ranges]
    state = tslam.init_slam(cfg, tuple(poses[0]), device=cuda_device)
    for i in range(4):
        state, _, _ = tslam.slam_step(state, scans[i], trng.derive_key(KEY, i), cfg)
    key = trng.derive_key(KEY, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, pose, _ = tslam.slam_step(state, scans[4], key, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(pose).all() and state.step == 5
