"""The port's session pool (parallel/sessions.py), MultiSessionNode and the
multi-log CLI, on the CPU: mirrors of tests/test_sessions.py's four cases in
its order, then the CLI on two ``.npz`` logs with the two launch files, the
fleet state carried between the packages, and a raster pool.

Tolerances: a pooled session against its solo run, bit for bit (the same
steps on the same data, whatever the other sessions do); the port's pool
against the JAX pool on the JAX package's scan points, poses 5e-4
(tests/test_torch_slam.py's trajectory tolerance); the state dict of a JAX
fleet state through the port and back, bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.io import synthetic as tsynth
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.node import MultiSessionNode, NodeConfig, SlamNode, main
from ndtpso_slam_tpu_torch.parallel.sessions import SlamSessionPool
from ndtpso_slam_tpu_torch.utils.state import fleet_state_from_numpy, fleet_state_to_numpy

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import scan as jscan
    from ndtpso_slam_tpu.models import slam as jslam
    from ndtpso_slam_tpu.parallel.sessions import SlamSessionPool as JPool
except ImportError:  # the GPU machine: no JAX
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_ATOL = 5e-4


def _cfg(m, **over):
    """tests/test_sessions.py's configuration."""
    return m.SlamConfig(
        pso=m.PSOConfig(iterations=8, population=40),
        map=m.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4),
        scan=m.ScanConfig(max_beams=128),
        cost_mode="fast",
        **over,
    )


CFG = _cfg(tcfg)


def _load_log(seed, n_scans):
    lg = tsynth.make_log(seed=seed, n_scans=n_scans, n_beams=120, world_size=40.0)
    return lg, [tscan.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max, CFG.scan,
                                 CFG.map, device="cpu") for r in lg.ranges]


def _solo_poses(cfg, lg, scans, key):
    st = tslam.init_slam(cfg, tuple(lg.poses[0]), "cpu")
    stacked = tscan.Scan(points=torch.stack([s.points for s in scans]),
                         valid=torch.stack([s.valid for s in scans]))
    return tslam.run_offline(st, stacked, tuple(int(k) for k in key), cfg)


def _interleave(pool, scans0, scans1):
    """Session 0 every poll, session 1 every other poll (two LiDARs at
    different rates); the poses each session got."""
    got0, got1 = [], []
    i0 = i1 = tick = 0
    while i0 < len(scans0) or i1 < len(scans1):
        if i0 < len(scans0):
            pool.submit(0, scans0[i0])
            i0 += 1
        if tick % 2 == 0 and i1 < len(scans1):
            pool.submit(1, scans1[i1])
            i1 += 1
        res = pool.poll()
        if 0 in res:
            got0.append(np.asarray(res[0][0], np.float64))
        if 1 in res:
            got1.append(np.asarray(res[1][0], np.float64))
        tick += 1
    return np.stack(got0), np.stack(got1)


def test_interleaved_sessions_match_solo_runs():
    """Sessions at two rates replay their solo run_offline bit for bit, and
    idle polls change nothing."""
    lg0, scans0 = _load_log(3, 8)
    lg1, scans1 = _load_log(4, 5)
    keys = np.array([[3, 9], [7, 21]], np.uint32)
    pool = SlamSessionPool(CFG, np.stack([lg0.poses[0], lg1.poses[0]]), keys, device="cpu")
    assert pool._use_flat
    got0, got1 = _interleave(pool, scans0, scans1)
    assert pool.poll() == {} and pool.pending() == 0
    for lg, scans, key, got in ((lg0, scans0, keys[0], got0), (lg1, scans1, keys[1], got1)):
        _, solo, _ = _solo_poses(CFG, lg, scans, key)
        np.testing.assert_array_equal(got, solo.numpy().astype(np.float64))


BASE = NodeConfig(frame_size_m=48.0, cell_side_m=1.0, window_slots=4, max_beams=128,
                  pso_iterations=8, pso_population=40, cost_mode="fast", build_og=False)


def test_multi_session_node_matches_solo_nodes(tmp_path):
    """MultiSessionNode (the dual-LiDAR CLI mode) == two solo SlamNodes of
    seeds seed and seed + 101 on the same logs, and per-session export
    bundles are written."""
    cfgs = [dataclasses.replace(BASE, init_pose=(8.0, 0.0, np.pi / 2)),
            dataclasses.replace(BASE, init_pose=(8.0, 0.0, np.pi / 2),
                                mount_trans=(0.1, 0.0, 0.05))]
    lg0 = tsynth.make_log(seed=3, n_scans=6, n_beams=120, world_size=40.0)
    lg1 = tsynth.make_log(seed=4, n_scans=4, n_beams=120, world_size=40.0, dt=0.15)
    mnode = MultiSessionNode(cfgs, verbose=False, device="cpu")
    poses = mnode.run_logs([lg0, lg1])
    assert len(poses[0]) == 6 and len(poses[1]) == 4
    for i, (cfg, lg) in enumerate(zip(cfgs, (lg0, lg1))):
        solo = SlamNode(dataclasses.replace(cfg, seed=cfg.seed + 101 * i), verbose=False,
                        device="cpu")
        np.testing.assert_array_equal(poses[i], solo.run_log(lg))
    files = mnode.shutdown(str(tmp_path / "duo"))
    for sid in (0, 1):
        assert any(f"duo-s{sid}" in f and f.endswith(".pose.csv") for f in files)
        assert any(f"duo-s{sid}" in f and f.endswith(".cells.csv") for f in files)


def test_multi_session_rejects_mismatched_shapes():
    a = NodeConfig(frame_size_m=48.0, cell_side_m=1.0, max_beams=128, window_slots=4)
    with pytest.raises(ValueError, match="shape-identical"):
        MultiSessionNode([a, dataclasses.replace(a, max_beams=256)], device="cpu")


def test_pool_session_state_slices_one_session():
    lg0, scans0 = _load_log(5, 3)
    lg1, scans1 = _load_log(6, 3)
    pool = SlamSessionPool(CFG, np.stack([lg0.poses[0], lg1.poses[0]]),
                           np.array([[1, 2], [3, 4]], np.uint32), device="cpu")
    for s0, s1 in zip(scans0, scans1):
        pool.submit(0, s0)
        pool.submit(1, s1)
    hist = pool.drain()
    st1 = pool.session_state(1)
    assert st1.step == 3 and st1.pose.shape == (3,) and torch.isfinite(st1.pose).all()
    np.testing.assert_array_equal(st1.pose.numpy(), hist[1][-1][0])
    # A view into the pool: the session's map is the pool's rows.
    assert st1.map.mean_c.data_ptr() == pool.states.map.mean_c[1].data_ptr()


# ------------------------------------------------------------ the CLI

FRONT, BACK = (os.path.join(REPO, "launch", f"lidar_{s}.json") for s in ("front", "back"))
CLI_FLAGS = ["--cost-mode", "fast", "--max-beams", "128", "--iterations", "8",
             "--population", "40", "--quiet", "--device", "cpu"]


def _sensor_log(path, seed, n_scans, dt, heading):
    """A log of a sensor that starts at the launch file's pose (0, 0,
    heading) and drives straight on, saved as .npz."""
    ts = np.arange(n_scans) * dt
    traj = np.stack([0.4 * ts * np.cos(heading), 0.4 * ts * np.sin(heading),
                     np.full_like(ts, heading)], -1)
    lg = tsynth.make_log(seed=seed, n_scans=n_scans, n_beams=120, world_size=40.0, dt=dt,
                         trajectory=traj)
    np.savez(path, ranges=lg.ranges, poses=lg.poses, odoms=lg.odoms, timestamps=lg.timestamps,
             angle_min=lg.angle_min, angle_increment=lg.angle_increment,
             range_max=lg.range_max)
    return lg


def test_multi_log_cli_with_two_launch_files(tmp_path):
    """Two .npz logs (front at 10 Hz, back at 5 Hz) with the two launch
    files through the CLI: one session each, bundles -s0/-s1, each pose CSV
    equal to a solo node of seed 42 + 101·i on its log; --checkpoint with
    two logs refused."""
    logs = [_sensor_log(tmp_path / "front.npz", 31, 8, 0.1, 0.0),
            _sensor_log(tmp_path / "back.npz", 32, 4, 0.2, np.pi)]
    out = str(tmp_path / "duo")
    argv = ["--scanlog", str(tmp_path / "front.npz"), "--scanlog", str(tmp_path / "back.npz"),
            "--config", FRONT, "--config", BACK, "--out", out, *CLI_FLAGS]
    assert main(argv) == 0
    overrides = dict(cost_mode="fast", max_beams=128, pso_iterations=8, pso_population=40)
    for i, (launch, lg) in enumerate(zip((FRONT, BACK), logs)):
        rows = np.loadtxt(f"{out}-s{i}.pose.csv", delimiter=",", skiprows=1, ndmin=2)
        assert rows.shape == (len(lg.ranges), 7)
        cfg = NodeConfig.from_json(launch, **overrides)
        solo = SlamNode(dataclasses.replace(cfg, seed=cfg.seed + 101 * i), verbose=False,
                        device="cpu")
        solo.run_log(lg)
        solo.shutdown(str(tmp_path / f"solo{i}"))
        assert open(f"{out}-s{i}.pose.csv").read() == open(tmp_path / f"solo{i}.pose.csv").read()
        for suffix in (".map.csv", ".gnuplot", ".cells.csv"):
            assert os.path.getsize(f"{out}-s{i}{suffix}") > 0
        assert np.hypot(*(rows[:, 1:3] - lg.poses[:, :2]).T).max() < 0.3
    with pytest.raises(SystemExit):
        main(argv + ["--checkpoint", str(tmp_path / "x.npz")])


def test_launch_files_load_with_their_comments():
    """The launch files' "_comment" keys are comments (ROADMAP R8); any
    other unknown key still raises."""
    front, back = NodeConfig.from_json(FRONT), NodeConfig.from_json(BACK)
    assert front.slam_config() == back.slam_config() and back.init_pose[2] == 3.14159265
    path = os.path.join(os.path.dirname(FRONT), "scan.json")
    assert NodeConfig.from_json(path).frame_size_m > 0


# ------------------------------------------- the fleet state and JAX


def _jax_scans(lg):
    cfg = _cfg(jcfg)
    return [jscan.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max, cfg.scan,
                             cfg.map) for r in lg.ranges]


def _shared(js):
    return tscan.Scan(points=torch.from_numpy(np.array(js.points)),
                      valid=torch.from_numpy(np.array(js.valid)))


def _jax_arrays(states):
    out = {f"map.{f.name}": np.asarray(getattr(states.map, f.name))
           for f in dataclasses.fields(states.map)}
    for name in ("prev_pose", "pose_diff", "iter"):
        out[f"align.{name}"] = np.asarray(getattr(states.align, name))
    for name in ("pose", "step", "fitness", "recoveries", "prev_ids"):
        out[name] = np.asarray(getattr(states, name))
    return out


def _jax_states(arrays, cfg):
    st = jslam.init_slam_batch(cfg, arrays["pose"])
    leaf = lambda k: jnp.asarray(arrays[k])
    m = st.map.replace(**{f.name: leaf(f"map.{f.name}") for f in dataclasses.fields(st.map)})
    align = jslam.AlignState(**{n: leaf(f"align.{n}") for n in ("prev_pose", "pose_diff", "iter")})
    return st.replace(map=m, align=align, **{n: leaf(n) for n in (
        "pose", "step", "fitness", "recoveries", "prev_ids")})


def _poll(pool, scans, t):
    for sid, sc in enumerate(scans):
        if t < len(sc):
            pool.submit(sid, sc[t])
    return {sid: np.asarray(p, np.float64) for sid, (p, _) in pool.poll().items()}


@needs_jax
def test_fleet_state_round_trips_with_a_jax_pool():
    """A JAX pool's stacked state through fleet_state_from_numpy and
    fleet_state_to_numpy, bit for bit, then continued by the port's pool
    beside the JAX pool; and the port's pool state continued by the JAX
    pool.  The two pools on the same scan points agree within 5e-4."""
    lgs = [tsynth.make_log(seed=s, n_scans=6, n_beams=120, world_size=40.0) for s in (7, 8)]
    jsc = [_jax_scans(lg) for lg in lgs]
    tsc = [[_shared(s) for s in row] for row in jsc]
    keys = np.array([[5, 6], [7, 8]], np.uint32)
    init = np.stack([lg.poses[0] for lg in lgs]).astype(np.float32)
    jpool = JPool(_cfg(jcfg), init, keys)
    tpool = SlamSessionPool(CFG, init, keys, device="cpu")
    for t in range(3):
        jres, tres = _poll(jpool, jsc, t), _poll(tpool, tsc, t)
        for sid in (0, 1):
            np.testing.assert_allclose(tres[sid], jres[sid], atol=TRAJ_ATOL)

    arrays = _jax_arrays(jpool.states)
    states = fleet_state_from_numpy(arrays, CFG, "cpu")
    back = fleet_state_to_numpy(states)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    from_jax = SlamSessionPool(CFG, init, keys, device="cpu")
    from_jax.states = states
    to_jax = JPool(_cfg(jcfg), init, keys)
    to_jax.states = _jax_states(fleet_state_to_numpy(tpool.states), _cfg(jcfg))
    to_jax.steps = np.asarray(tpool.states.step).copy()
    for t in range(3, 6):
        pairs = ((_poll(jpool, jsc, t), _poll(from_jax, tsc, t)),
                 (_poll(to_jax, jsc, t), _poll(tpool, tsc, t)))
        for jres, tres in pairs:
            for sid in (0, 1):
                np.testing.assert_allclose(tres[sid], jres[sid], atol=TRAJ_ATOL)
    assert list(from_jax.states.step) == [6, 6] == list(np.asarray(to_jax.states.step))


def test_raster_pool_runs_the_per_session_step():
    """A pool with the occupancy raster takes the per-session step (the flat
    step does not raster); each session bit for bit its solo run, raster
    included."""
    cfg = dataclasses.replace(CFG, og=tcfg.OccupancyGridConfig(enabled=True, cell_size_m=0.5))
    lg0, scans0 = _load_log(3, 4)
    lg1, scans1 = _load_log(4, 3)
    keys = np.array([[3, 9], [7, 21]], np.uint32)
    pool = SlamSessionPool(cfg, np.stack([lg0.poses[0], lg1.poses[0]]), keys, device="cpu")
    assert not pool._use_flat
    got0, got1 = _interleave(pool, scans0, scans1)
    for i, (lg, scans, got) in enumerate(((lg0, scans0, got0), (lg1, scans1, got1))):
        solo, poses, _ = _solo_poses(cfg, lg, scans, keys[i])
        np.testing.assert_array_equal(got, poses.numpy().astype(np.float64))
        view = pool.session_state(i)
        assert torch.equal(view.og.og, solo.og.og) and int(solo.og.og.count_nonzero()) > 0
        assert int(view.og.min_y) == int(solo.og.min_y)
