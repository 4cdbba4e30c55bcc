"""The node's options that the port runs since it ported them (GLIR-PSO on
the plain cost modes, a sparse ring, frontal-point decimation, the stencil
patch) against the JAX package on the CPU, at tests/test_torch_slam.py's
scale and tolerance: each option through both nodes over 8 scans, the
frontal masks and the patch binds bit for bit, a covering patch and a
roomy sparse ring changing no pose of the port's own run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndtpso_slam_tpu import config as jcfg
from ndtpso_slam_tpu.models import scan as jscan

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode
from ndtpso_slam_tpu_torch.utils.state import snapshot_from_numpy

from test_torch_slam import SMALL, TRAJ_ATOL, _cfgs, ellipse_world, log  # noqa: F401 (fixtures)


def _node_pair(log, **over):
    """The JAX node and the port's (on the CPU) over the log at SMALL's
    configuration with ``over``: (JAX node, port node, JAX poses, port
    poses).  Where the port runs rollout_local (K1's plain version), the
    JAX node runs local_exact, the solve the JAX package holds its
    rollout_local to (tests/test_rollout.py), at half its compile time."""
    from ndtpso_slam_tpu.node import NodeConfig as JNodeConfig, SlamNode as JSlamNode

    kw = {**SMALL, "init_pose": tuple(log.poses[0]), "cost_mode": "rollout_local", **over}
    jmode = "local_exact" if kw["cost_mode"] == "rollout_local" else kw["cost_mode"]
    jn = JSlamNode(JNodeConfig(**{**kw, "cost_mode": jmode}), verbose=False)
    tn = SlamNode(NodeConfig(**kw), verbose=False, device="cpu")
    return jn, tn, jn.run_log(log), tn.run_log(log)


# The four node options the port used to refuse, each run by the node and
# held to the JAX node over the log's 8 scans (the parity tolerance): GLIR
# on a plain cost mode, a sparse ring small enough to overflow, frontal-point
# decimation, and a stencil patch of 104 cells in a 56 m frame of 112.  (In
# frames of 64-80 m the two packages part at a near-tie decision of this
# small 40 x 20 budget, with the patch and without it alike; from the same
# state the two solve that scan to within 2e-7.)
@pytest.mark.parametrize("override", [
    dict(optimizer="glir", cost_mode="local_exact"),
    dict(ring_rows=64),
    dict(prefer_frontal_points=True),
    dict(patch_range_m=22.0, frame_size_m=56.0),
], ids=["glir", "ring_rows", "prefer_frontal_points", "patch_range_m"])
def test_node_option_matches_jax(log, override):
    jn, tn, jp, tp = _node_pair(log, **override)
    np.testing.assert_allclose(tp, jp, atol=TRAJ_ATOL)
    assert np.isfinite(tp).all()
    if "ring_rows" in override:  # the same rows given out, the same cells refused
        assert int(tn.state.map.ring_overflow) == int(jn.state.map.ring_overflow) > 0
        assert int(tn.state.map.ring_used) == int(jn.state.map.ring_used) == 64
    if "patch_range_m" in override:
        assert 0 < tn.slam_cfg.map.stencil_patch_cells < tn.slam_cfg.map.cells_per_side


def test_glir_with_rollout_raises_value_error():
    """GLIR with a rollout* mode: the whole-solve kernels run the deployed
    PSO rule only, and the port refuses the pair with the JAX package's
    ValueError (tests/test_node.py::test_glir_rejects_rollout_modes)."""
    with pytest.raises(ValueError, match="rollout"):
        SlamNode(NodeConfig(**{**SMALL, "cost_mode": "rollout_local_turbo",
                               "optimizer": "glir"}), verbose=False, device="cpu")


def test_sparse_ring_node_matches_jax_and_dense(log):
    """A sparse ring with room to spare (R = 2048): the node's poses equal
    the port's dense-ring run bit for bit (only the ring's storage differs)
    and the JAX sparse-ring node's within the parity tolerance, with the
    same rows given out."""
    jn, tn, jp, tp = _node_pair(log, ring_rows=2048)
    dense = SlamNode(NodeConfig(**SMALL, init_pose=tuple(log.poses[0]),
                                cost_mode="rollout_local"), verbose=False, device="cpu")
    np.testing.assert_array_equal(tp, dense.run_log(log))
    np.testing.assert_allclose(tp, jp, atol=TRAJ_ATOL)
    assert int(tn.state.map.ring_overflow) == 0
    assert 0 < int(tn.state.map.ring_used) == int(jn.state.map.ring_used)


def test_frontal_decimation_matches_jax(log):
    """PREFER_FRONTAL_POINTS in the node: every scan's valid mask bit for bit
    against the JAX package's load_laser (and fewer beams than without it)."""
    jc, tc = _cfgs("rollout_local")
    jc = dataclasses.replace(jc, scan=jcfg.ScanConfig(max_beams=256, prefer_frontal_points=True))
    node = SlamNode(NodeConfig(**SMALL, prefer_frontal_points=True), verbose=False, device="cpu")
    assert node.slam_cfg.scan.prefer_frontal_points
    for r in log.ranges:
        js = jscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max, jc.scan, jc.map)
        ts = tscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max,
                              node.slam_cfg.scan, node.slam_cfg.map, device="cpu")
        full = tscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max,
                                tc.scan, tc.map, device="cpu")
        np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
        assert 0 < int(ts.valid.sum()) < int(full.valid.sum())


def _patch_binds(w, ps, anchor):
    """bind_neighborhood with a ps-cell stencil patch, JAX (its roll over the
    patch) and port (a mask on the gather), on the ellipse world."""
    from ndtpso_slam_tpu.models import cost as jcost
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu_torch.models import cost as tcost

    kw = dict(size_m=32.0, cell_side_m=1.0, window_slots=4, stencil_patch_cells=ps)
    a = np.float32(anchor)
    jb = jcost.bind_neighborhood(
        jnp.asarray(a), jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in w["snap"].items()}),
        jnp.asarray(w["points"]), jnp.asarray(w["valid"]), jcfg.MapConfig(**kw))
    tm = tcfg.MapConfig(**kw)
    tb = tcost.bind_neighborhood(torch.from_numpy(a), snapshot_from_numpy(w["snap"], "cpu"),
                                 torch.from_numpy(w["points"]), torch.from_numpy(w["valid"]), tm)
    ox, oy = (int(v) for v in tcost.window_origin(torch.from_numpy(a), ps, tm))
    ix, iy = tb.anchor_ix.numpy(), tb.anchor_iy.numpy()
    inside = (ix >= ox) & (ix < ox + ps) & (iy >= oy) & (iy < oy + ps)
    return jb, tb, inside


@pytest.mark.parametrize("ps,anchor", [(24, (0.3, -0.2, 0.05)), (24, (2.0, 1.5, 0.4)),
                                       (16, (0.3, -0.2, 0.05))])
def test_patch_bind_matches_jax(ellipse_world, ps, anchor):
    """The stencil patch as a mask on the gather against the JAX package's
    roll over a dynamic slice: anchor cells bit for bit; for every point
    whose anchor cell lies in the patch, `built` bit for bit and the
    statistics of its built lanes bit for bit.  A 24-cell patch covers the
    ellipse (every point's anchor inside); a 16-cell one does not, and
    there the JAX roll reads the clipped anchor's neighbours for a point
    anchored outside the patch (ROADMAP R6), while the port keeps the rule
    that only in-patch neighbours count."""
    jb, tb, inside = _patch_binds(ellipse_world, ps, anchor)
    np.testing.assert_array_equal(tb.anchor_ix.numpy(), np.asarray(jb.anchor_ix))
    np.testing.assert_array_equal(tb.anchor_iy.numpy(), np.asarray(jb.anchor_iy))
    built = tb.built.numpy()
    np.testing.assert_array_equal(built[inside], np.asarray(jb.built)[inside])
    lanes = built & inside[:, None]
    assert lanes.sum() > 100
    np.testing.assert_array_equal(tb.mean.numpy()[lanes], np.asarray(jb.mean)[lanes])
    np.testing.assert_array_equal(tb.icov.numpy()[lanes], np.asarray(jb.icov)[lanes])
    if ps == 24:
        assert inside[ellipse_world["valid"]].all()
    else:  # R6: the reference's lanes differ only for points anchored outside
        assert (~inside).any()
        assert (np.asarray(jb.built)[~inside] != built[~inside]).any()
        nix = tb.anchor_ix.numpy()[:, None] + np.tile(np.arange(-2, 3), 5)
        niy = tb.anchor_iy.numpy()[:, None] + np.repeat(np.arange(-2, 3), 5)
        from ndtpso_slam_tpu_torch.models import cost as tcost

        ox, oy = (int(v) for v in tcost.window_origin(
            torch.tensor(anchor, dtype=torch.float32), ps,
            tcfg.MapConfig(size_m=32.0, cell_side_m=1.0, stencil_patch_cells=ps)))
        out = (nix < ox) | (nix >= ox + ps) | (niy < oy) | (niy >= oy + ps)
        assert not built[out].any()


def test_covering_patch_changes_nothing(log):
    """A stencil patch that covers every scan (tests/test_cost.py's
    condition: 128 cells around a scan whose longest valid beam is 27.3 m)
    leaves the node's poses bit for bit as without it."""
    r = log.ranges
    assert r[(r > 0.1) & (r < log.range_max)].max() < 28.0
    kw = dict(SMALL, frame_size_m=72.0, init_pose=tuple(log.poses[0]), cost_mode="rollout_local")
    patched = SlamNode(NodeConfig(**kw, patch_range_m=28.0), verbose=False, device="cpu")
    ps = patched.slam_cfg.map.stencil_patch_cells
    assert 0 < ps < patched.slam_cfg.map.cells_per_side
    plain = SlamNode(NodeConfig(**kw), verbose=False, device="cpu")
    np.testing.assert_array_equal(patched.run_log(log), plain.run_log(log))


def test_glir_step_from_a_jax_state_on_realistic_data():
    """GLIR on the committed bag (tests/test_realdata.py's configuration,
    local_exact): the JAX node's state after 6 scans, continued one scan by
    each package, gives the same pose within the parity tolerance.  (Whole
    GLIR runs part within a few scans: its ratio attractors amplify ulps.)"""
    import os

    from ndtpso_slam_tpu.models import slam as jslam
    from ndtpso_slam_tpu.ops import rng as jrng
    from ndtpso_slam_tpu_torch.io import importers
    from ndtpso_slam_tpu_torch.models import slam as tslam
    from ndtpso_slam_tpu_torch.utils.state import slam_state_from_numpy
    from test_torch_slam import _jax_state_to_numpy

    lg = importers.load_log(os.path.join(os.path.dirname(__file__), "data", "realistic.bag"))
    kw = lambda m: dict(pso=m.PSOConfig(iterations=30, population=50),
                        map=m.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=8),
                        scan=m.ScanConfig(max_beams=540), cost_mode="local_exact",
                        optimizer="glir")
    jc, tc = jcfg.SlamConfig(**kw(jcfg)), tcfg.SlamConfig(**kw(tcfg))
    key = lambda i: jrng.threefry2x32((np.uint32(3), np.uint32(9)), np.uint32(i), np.uint32(0))
    load = lambda m, c, i, **d: m.load_laser(lg.ranges[i], lg.angle_min, lg.angle_increment,
                                             lg.range_max, c.scan, c.map, **d)
    state = jslam.init_slam(jc, tuple(float(v) for v in lg.odoms[0]))
    for i in range(6):
        state, _, _ = jslam.slam_step(state, load(jscan, jc, i), key(i), jc)
    tstate = slam_state_from_numpy(_jax_state_to_numpy(state), tc, "cpu")
    _, jpose, _ = jslam.slam_step(state, load(jscan, jc, 6), key(6), jc)
    _, tpose, _ = tslam.slam_step(tstate, load(tscan, tc, 6, device="cpu"),
                                  tslam.rng.derive_key((3, 9), 6), tc)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=TRAJ_ATOL)
