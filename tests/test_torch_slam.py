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
from ndtpso_slam_tpu_torch.utils.state import slam_state_from_numpy, slam_state_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_KEY = (3, 9)
TRAJ_ATOL = 5e-4


def _cfgs(cost_mode):
    """The JAX package's rollout_local SLAM test scale (tests/test_rollout.py)."""
    kw = lambda m: dict(
        pso=m.PSOConfig(iterations=25, population=50),
        map=m.MapConfig(size_m=36.0, cell_side_m=0.5, window_slots=4),
        scan=m.ScanConfig(max_beams=256),
        og=m.OccupancyGridConfig(enabled=False),
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
    return out


def test_port_continues_jax_mid_run_state(log):
    jc, tc = _cfgs("local_exact")
    jstate, _ = _jax_run(jslam.init_slam(jc, tuple(log.poses[0])), jc, log, range(5))
    arrays = _jax_state_to_numpy(jstate)
    tstate = slam_state_from_numpy(arrays, tc, device="cpu")
    back = slam_state_to_numpy(tstate)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    _, jp = _jax_run(jstate, jc, log, range(5, 8))
    tstate, tp = _port_run(tstate, tc, log, range(5, 8))
    np.testing.assert_allclose(tp, jp, atol=TRAJ_ATOL)
    assert tstate.step == 8


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


def test_node_cli_subprocess(log, tmp_path):
    npz = tmp_path / "x.npz"
    np.savez(npz, ranges=log.ranges, poses=log.poses, odoms=log.odoms,
             timestamps=log.timestamps, angle_min=log.angle_min,
             angle_increment=log.angle_increment, range_max=log.range_max)
    launch = tmp_path / "launch.json"
    launch.write_text(json.dumps({"init_pose": [float(v) for v in log.poses[0]],
                                  "window_slots": 4}))
    cmd = [
        sys.executable, "-m", "ndtpso_slam_tpu_torch.node", "--device", "cpu",
        "--scanlog", str(npz), "--config", str(launch), "--out", "run",
        "--cost-mode", "rollout_local",
        "--frame-size", "36", "--cell-side", "0.5", "--max-beams", "256",
        "--iterations", "25", "--population", "50", "--seed", "5", "--quiet",
    ]
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    lines = (tmp_path / "run.pose.csv").read_text().strip().split("\n")
    assert len(lines) == 9
    rows = np.array([[float(v) for v in line.split(",")] for line in lines[1:]])
    np.testing.assert_allclose(rows[:, 0], log.timestamps, atol=1e-6)
    np.testing.assert_allclose(rows[:, 4:7], log.odoms, atol=1e-5)
    err = np.hypot(*(rows[:, 1:3] - log.poses[:, :2]).T)
    assert err.max() < 0.25, f"CLI tracking error {err.max():.3f}"


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


@pytest.mark.parametrize("override,roadmap", [
    (dict(build_og=True), "B1"),
    (dict(recovery=True), "B2"),
    (dict(optimizer="glir"), "B3"),
    (dict(ring_rows=64), "A5"),
    (dict(prefer_frontal_points=True), "A4"),
    (dict(patch_range_m=30.0), "A6"),
    (dict(cost_mode="fast"), "ROADMAP"),
    (dict(cost_mode="rollout_local_turbo"), "ROADMAP"),
])
def test_unported_options_raise(override, roadmap):
    with pytest.raises(NotImplementedError, match=roadmap):
        SlamNode(NodeConfig(**{**SMALL, **override}), verbose=False, device="cpu")


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
    with pytest.raises(NotImplementedError, match="A10"):
        load_log(str(tmp_path / "l.bag"))
