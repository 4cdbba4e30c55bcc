"""The port's sequential SLAM slice against the JAX package, on the CPU:
slam_step over 8 scans, a JAX mid-run state continued by the port, the node,
its CLI, and the no-JAX / no-GPU rules.

Trajectories are held to atol 5e-4, the tolerance the JAX package holds its
own rollout_local-vs-local_exact trajectories to (tests/test_rollout.py):
the two sides load scans and transform points with sin/cos that differ in the
last ulp, so maps and costs differ in their last bits and a PSO decision may
flip between nearly equal particles.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpso_slam_tpu import config as jcfg
from ndtpso_slam_tpu.io import synthetic as jsynth
from ndtpso_slam_tpu.models import scan as jscan
from ndtpso_slam_tpu.models import slam as jslam
from ndtpso_slam_tpu.ops import rng as jrng

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.io import synthetic as tsynth
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode
from ndtpso_slam_tpu_torch.ops import rollout_local as trl
from ndtpso_slam_tpu_torch.utils.state import (
    slam_state_from_numpy,
    slam_state_to_numpy,
    snapshot_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_KEY = (3, 9)
TRAJ_ATOL = 5e-4


def _cfgs(cost_mode, og=False):
    """The JAX package's rollout_local SLAM test scale (tests/test_rollout.py)."""
    kw = lambda m: dict(
        pso=m.PSOConfig(iterations=25, population=50),
        map=m.MapConfig(size_m=36.0, cell_side_m=0.5, window_slots=4),
        scan=m.ScanConfig(max_beams=256),
        og=m.OccupancyGridConfig(enabled=og),
        cost_mode=cost_mode,
    )
    return jcfg.SlamConfig(**kw(jcfg)), tcfg.SlamConfig(**kw(tcfg))


@pytest.fixture(scope="module")
def log():
    return jsynth.make_log(seed=3, n_scans=8, n_beams=256, world_size=30.0, odom_noise=0.02)


def _jax_run(state, cfg, log, steps):
    poses = []
    for i in steps:
        sc = jscan.load_laser(log.ranges[i], log.angle_min, log.angle_increment,
                              log.range_max, cfg.scan, cfg.map)
        key = jrng.threefry2x32((np.uint32(BASE_KEY[0]), np.uint32(BASE_KEY[1])),
                                np.uint32(i), np.uint32(0))
        state, pose, _ = jslam.slam_step(state, sc, key, cfg)
        poses.append(np.asarray(pose, np.float64))
    return state, np.stack(poses)


def _port_run(state, cfg, log, steps):
    poses = []
    for i in steps:
        sc = tscan.load_laser(log.ranges[i], log.angle_min, log.angle_increment,
                              log.range_max, cfg.scan, cfg.map, device="cpu")
        state, pose, _ = tslam.slam_step(state, sc, tslam.rng.derive_key(BASE_KEY, i), cfg)
        poses.append(pose.numpy().astype(np.float64))
    return state, np.stack(poses)


@pytest.mark.parametrize("cost_mode", ["local_exact", "rollout_local"])
def test_slam_steps_match_jax(log, cost_mode):
    jc, tc = _cfgs(cost_mode)
    _, jp = _jax_run(jslam.init_slam(jc, tuple(log.poses[0])), jc, log, range(8))
    before = trl.pso_rollout_local.LAUNCHES
    state, tp = _port_run(tslam.init_slam(tc, tuple(log.poses[0]), device="cpu"), tc, log, range(8))
    assert trl.pso_rollout_local.LAUNCHES == before  # the CPU path never launches
    np.testing.assert_allclose(tp, jp, atol=TRAJ_ATOL)
    err = np.hypot(*(tp[:, :2] - log.poses[:, :2]).T)
    assert err.max() < 0.25, f"port tracking error {err.max():.3f}"
    assert state.step == 8 and state.align.iter == 7
    assert float(state.fitness) > 0.1


def _jax_state_to_numpy(state):
    out = {f"map.{f.name}": np.asarray(getattr(state.map, f.name))
           for f in dataclasses.fields(state.map)}
    for name in ("prev_pose", "pose_diff", "iter"):
        out[f"align.{name}"] = np.asarray(getattr(state.align, name))
    for name in ("pose", "step", "fitness", "recoveries", "prev_ids"):
        out[name] = np.asarray(getattr(state, name))
    if state.og is not None:
        for f in dataclasses.fields(state.og):
            out[f"og.{f.name}"] = np.asarray(getattr(state.og, f.name))
    return out


def test_port_continues_jax_mid_run_state(log):
    """A JAX state that carries an occupancy grid, taken mid-run, through
    the port's state dict both ways, then continued by both packages."""
    jc, tc = _cfgs("local_exact", og=True)
    jstate, _ = _jax_run(jslam.init_slam(jc, tuple(log.poses[0])), jc, log, range(5))
    arrays = _jax_state_to_numpy(jstate)
    assert "og.og" in arrays and int(np.count_nonzero(arrays["og.og"])) > 0
    tstate = slam_state_from_numpy(arrays, tc, device="cpu")
    back = slam_state_to_numpy(tstate)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jstate, jp = _jax_run(jstate, jc, log, range(5, 8))
    tstate, tp = _port_run(tstate, tc, log, range(5, 8))
    np.testing.assert_allclose(tp, jp, atol=TRAJ_ATOL)
    assert tstate.step == 8
    # The raster within 1 unit of the JAX package's (an exp ulp across an
    # int8 truncation; tests/test_torch_occupancy.py), its bounds equal.
    jog = _jax_state_to_numpy(jstate)
    diff = np.abs(tstate.og.og.numpy().astype(int) - jog["og.og"].astype(int))
    assert diff.max() <= 1 and (diff > 0).sum() <= 8, ((diff > 0).sum(), diff.max())
    for name in ("min_x", "max_x", "min_y", "max_y"):
        assert int(getattr(tstate.og, name)) == int(jog[f"og.{name}"]), name
    with pytest.raises(ValueError, match="og.enabled"):
        slam_state_from_numpy(arrays, _cfgs("local_exact")[1], device="cpu")


def test_run_offline_equals_step_loop(log):
    _, tc = _cfgs("exact")
    tc = dataclasses.replace(tc, pso=tcfg.PSOConfig(iterations=10, population=20))
    scans = [tscan.load_laser(r, log.angle_min, log.angle_increment, log.range_max,
                              tc.scan, tc.map, device="cpu") for r in log.ranges[:4]]
    stacked = tscan.Scan(points=torch.stack([s.points for s in scans]),
                         valid=torch.stack([s.valid for s in scans]))
    _, poses, costs = tslam.run_offline(
        tslam.init_slam(tc, tuple(log.poses[0]), device="cpu"), stacked, BASE_KEY, tc)
    state = tslam.init_slam(tc, tuple(log.poses[0]), device="cpu")
    for i, sc in enumerate(scans):
        state, pose, c = tslam.slam_step(state, sc, tslam.rng.derive_key(BASE_KEY, i), tc)
        np.testing.assert_array_equal(poses[i].numpy(), pose.numpy())
        np.testing.assert_array_equal(costs[i].numpy(), c.numpy())
    assert costs.shape == (4,) and float(costs[0]) == 0.0  # empty first map


SMALL = dict(frame_size_m=36.0, cell_side_m=0.5, window_slots=4, max_beams=256,
             pso_iterations=20, pso_population=40)


def test_node_run_log_tracks_and_writes_poses(log, tmp_path):
    node = SlamNode(NodeConfig(**SMALL, init_pose=tuple(log.poses[0]), cost_mode="rollout_local"),
                    verbose=False, device="cpu")
    received = []
    node.on_pose(lambda ts, pose: received.append((ts, pose)))
    poses = node.run_log(log)
    assert poses.shape == (8, 3) and len(received) == 8
    err = np.hypot(*(poses[:, :2] - log.poses[:, :2]).T)
    assert err.max() < 0.25, f"node tracking error {err.max():.3f}"
    assert node.meter.average_rate_hz > 0
    files = node.shutdown(str(tmp_path / "run"))
    lines = open(files[0]).read().strip().split("\n")
    assert lines[0] == "timestamp,xP,yP,thP,xO,yO,thO"
    assert len(lines) == 9 and len(lines[1].split(",")) == 7


def _cli(log, tmp_path, out, *extra):
    """The node's CLI over the log on the CPU; returns the pose CSV's rows."""
    npz = tmp_path / "x.npz"
    np.savez(npz, ranges=log.ranges, poses=log.poses, odoms=log.odoms,
             timestamps=log.timestamps, angle_min=log.angle_min,
             angle_increment=log.angle_increment, range_max=log.range_max)
    launch = tmp_path / "launch.json"
    launch.write_text(json.dumps({"init_pose": [float(v) for v in log.poses[0]],
                                  "window_slots": 4}))
    cmd = [
        sys.executable, "-m", "ndtpso_slam_tpu_torch.node", "--device", "cpu",
        "--scanlog", str(npz), "--config", str(launch), "--out", out,
        "--cost-mode", "rollout_local",
        "--frame-size", "36", "--cell-side", "0.5", "--max-beams", "256",
        "--iterations", "25", "--population", "50", "--seed", "5", "--quiet", *extra,
    ]
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    lines = (tmp_path / f"{out}.pose.csv").read_text().strip().split("\n")
    assert len(lines) == 9
    return np.array([[float(v) for v in line.split(",")] for line in lines[1:]])


def test_node_cli_subprocess(log, tmp_path):
    rows = _cli(log, tmp_path, "run")
    np.testing.assert_allclose(rows[:, 0], log.timestamps, atol=1e-6)
    np.testing.assert_allclose(rows[:, 4:7], log.odoms, atol=1e-5)
    err = np.hypot(*(rows[:, 1:3] - log.poses[:, :2]).T)
    assert err.max() < 0.25, f"CLI tracking error {err.max():.3f}"
    # --og builds the raster; the poses do not move.  Neither does
    # --recovery on this healthy log.
    np.testing.assert_array_equal(_cli(log, tmp_path, "run_og", "--og"), rows)
    np.testing.assert_array_equal(_cli(log, tmp_path, "run_rec", "--recovery"), rows)


def test_node_build_og_runs_and_leaves_poses(log):
    """The node with build_og=True (the CLI's --og): the raster is built
    every scan, matches the dense pass over the final map up to the blocks
    R1 leaves stale, and the poses equal the run without it, bit for bit."""
    from ndtpso_slam_tpu_torch.models import occupancy as tocc

    runs = {}
    for og in (False, True):
        node = SlamNode(NodeConfig(**SMALL, init_pose=tuple(log.poses[0]), build_og=og,
                                   cost_mode="rollout_local"), verbose=False, device="cpu")
        runs[og] = (node, node.run_log(log))
    (off, p_off), (on, p_on) = runs[False], runs[True]
    assert off.state.og is None and on.state.og is not None
    np.testing.assert_array_equal(p_on, p_off)
    og = on.state.og
    assert og.og.shape == (360, 360) and int(torch.count_nonzero(og.og)) > 100
    assert 0 <= int(og.min_x) <= int(og.max_x) < 360 and 0 <= int(og.min_y) <= int(og.max_y) < 360
    cfg = on.slam_cfg
    dense = tocc.og_update(tocc.init_og(cfg.map, cfg.og, "cpu"), on.state.map, cfg.map, cfg.og)
    stale = (dense.og != og.og).sum().item()
    assert stale <= 0.05 * int(torch.count_nonzero(dense.og)), stale


def test_import_leaves_jax_out():
    code = (
        "import pkgutil, sys, importlib, ndtpso_slam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ndtpso_slam_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_default_device_is_cuda_and_raises_without_gpu(log):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    _, tc = _cfgs("rollout_local")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tslam.init_slam(tc)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SlamNode(NodeConfig(**SMALL), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tscan.load_laser(log.ranges[0], log.angle_min, log.angle_increment,
                         log.range_max, tc.scan)


@pytest.mark.parametrize("cost_mode", ["exact", "fast"])
def test_node_recovery_relocalizes_after_kidnap(cost_mode, capsys):
    """The node with recovery on (the CLI's --recovery) over
    tests/test_recovery.py's kidnap workload: the tracking loss is detected
    and a relocalization accepted, in the exact and the frozen-cost align;
    the verbose line reports fitness and recoveries."""
    from test_torch_recovery import kidnap_workload

    poses, ranges = kidnap_workload()
    node = SlamNode(NodeConfig(frame_size_m=48.0, cell_side_m=1.0, window_slots=8, max_beams=360,
                               pso_iterations=30, pso_population=50, cost_mode=cost_mode,
                               recovery=True, recovery_fitness_threshold=0.2,
                               init_pose=tuple(poses[0]), seed=7), device="cpu")
    assert node.slam_cfg.recovery.enabled and node.slam_cfg.recovery.grid == (24, 24, 32)
    for i, r in enumerate(ranges):
        node.process_scan(r, -np.pi, 2 * np.pi / 360, 30.0, timestamp=0.1 * i)
    assert node.state.recoveries >= 1
    assert np.isfinite(np.stack(node.poses)).all()
    assert "recoveries 1" in capsys.readouterr().err


def test_synthetic_copy_matches_jax_package():
    for kw in (dict(seed=2, n_scans=5, n_beams=360, world_size=50.0),
               dict(seed=3, n_scans=4, n_beams=256, world_size=30.0, odom_noise=0.02)):
        j, t = jsynth.make_log(**kw), tsynth.make_log(**kw)
        for name in j._fields:
            np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)))


def test_npz_log_roundtrip(log, tmp_path):
    from ndtpso_slam_tpu_torch.io.importers import load_log

    path = str(tmp_path / "l.npz")
    np.savez(path, ranges=log.ranges, timestamps=log.timestamps, angle_min=log.angle_min,
             angle_increment=log.angle_increment, range_max=log.range_max)
    got = load_log(path)
    np.testing.assert_array_equal(got.ranges, log.ranges)
    assert got.poses is None and got.range_max == log.range_max
    from ndtpso_slam_tpu_torch.io.rosbag import write_bag

    bag = str(tmp_path / "l.bag")
    write_bag(bag, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
              log.range_max, odoms=log.odoms)
    got = load_log(bag)
    np.testing.assert_array_equal(got.ranges, log.ranges)
    np.testing.assert_allclose(got.odoms, log.odoms, atol=1e-9)


@pytest.fixture(scope="module")
def ellipse_world():
    """The JAX package's rollout test map (tests/test_rollout.py), built by
    the port (bit-equal to the JAX map on the CPU), and its 200 points
    padded to 256 beams."""
    from ndtpso_slam_tpu_torch.models import ndt_map as tmap

    mc = tcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))).astype(np.float32)
    state = tmap.init_map(mc, device="cpu")
    for _ in range(2):
        noisy = pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)
        tmap.add_points(state, mc, torch.from_numpy(noisy), torch.ones(200, dtype=torch.bool))
        tmap.build(state, mc)
    snap = tmap.snapshot(state, mc)
    points = np.zeros((256, 2), np.float32)
    points[:200] = pts
    valid = np.zeros(256, bool)
    valid[:200] = True
    return dict(snap={k: getattr(snap, k).numpy() for k in ("mean", "inv_cov", "built")},
                points=points, valid=valid)


@pytest.mark.parametrize("mode", [
    "rollout", "fast", "fast_local", "rollout_turbo", "rollout_local_turbo",
])
def test_slam_align_runs_reference_budget(ellipse_world, mode):
    """Mirror of tests/test_rollout.py::test_slam_rollout_runs_reference_budget
    for the modes the align now takes: the node's 50-particle budget through
    align from a cold start.  Against the JAX run, poses to the frozen-mode
    tolerance (5e-3, tests/test_rollout.py), and both re-score the winner
    with the exact cost; the turbo modes (Philox draws, not the TPU's
    stream) are held to the accuracy gate only."""
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.models.scan import Scan as JScan

    kw = lambda m: dict(pso=m.PSOConfig(iterations=8, population=50),
                        map=m.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4),
                        scan=m.ScanConfig(max_beams=256), cost_mode=mode)
    jc, tc = jcfg.SlamConfig(**kw(jcfg)), tcfg.SlamConfig(**kw(tcfg))
    w = ellipse_world
    tastate = tslam.AlignState(prev_pose=torch.zeros(3), pose_diff=torch.zeros(3), iter=0)
    _, tres = tslam.align(
        (5, 7), tastate, snapshot_from_numpy(w["snap"], "cpu"),
        tscan.Scan(points=torch.from_numpy(w["points"]), valid=torch.from_numpy(w["valid"])),
        torch.zeros(3), tc)
    pose = tres.pose.numpy()
    assert np.abs(pose[:2]).max() < 0.1 and abs(pose[2]) < 0.05
    assert np.isfinite(float(tres.cost))
    if "turbo" in mode:
        return
    jastate = jslam.AlignState(prev_pose=jnp.zeros(3, jnp.float32),
                               pose_diff=jnp.zeros(3, jnp.float32), iter=jnp.asarray(0, jnp.int32))
    _, jres = jax.jit(jslam.align, static_argnums=5)(  # as the JAX SLAM step runs it
        (np.uint32(5), np.uint32(7)), jastate,
        jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in w["snap"].items()}),
        JScan(points=jnp.asarray(w["points"]), valid=jnp.asarray(w["valid"])),
        jnp.zeros(3, jnp.float32), jc)
    np.testing.assert_allclose(pose, np.asarray(jres.pose), atol=5e-3)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-4, atol=1e-3)
