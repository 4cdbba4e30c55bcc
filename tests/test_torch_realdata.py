"""The port's log readers and the real-data gate, on the CPU.

The ``.bag``, ``.csv`` and ``.ndtlog`` readers against the JAX package's
(``io/rosbag.py``, ``io/importers.py``, the native runtime's scan-log reader)
bit for bit, their round trips (tests/test_realdata.py's), and SLAM over the
committed realistic bag (noise, 5% dropout, moving clutter, drifting
odometry): the port's node under tests/test_realdata.py's gate, and its first
8 scans against the JAX node (atol 5e-4, the parity tolerance of
tests/test_torch_slam.py).
"""

import importlib.util
import os

import numpy as np
import pytest

from ndtpso_slam_tpu.io import importers as jimporters
from ndtpso_slam_tpu.io import rosbag as jrosbag
from ndtpso_slam_tpu.io import synthetic as jsynth
from ndtpso_slam_tpu.utils import native

from ndtpso_slam_tpu_torch.io import importers as timporters
from ndtpso_slam_tpu_torch.io import rosbag as trosbag
from ndtpso_slam_tpu_torch.io import synthetic as tsynth
from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "realistic.bag")
FIXTURE_GT = os.path.join(HERE, "data", "realistic_gt.npy")
TRAJ_ATOL = 5e-4
# tests/test_realdata.py:98-126's configuration, from the odometry's first pose.
REAL = dict(frame_size_m=48.0, cell_side_m=1.0, window_slots=8, max_beams=540,
            pso_iterations=30, pso_population=50, cost_mode="fast_local")


def _small_log():
    return tsynth.make_log(seed=9, n_scans=5, n_beams=90, world_size=30.0, odom_noise=0.01)


def _assert_logs_equal(got, want):
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert type(g) is type(w), name
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, name


def test_read_bag_matches_jax_on_the_fixture():
    got = trosbag.read_bag(FIXTURE)
    assert got.ranges.shape == (60, 540)
    _assert_logs_equal(got, jrosbag.read_bag(FIXTURE))
    _assert_logs_equal(timporters.load_log(FIXTURE), jimporters.load_log(FIXTURE))


def test_bag_roundtrip(tmp_path):
    log = _small_log()
    path = str(tmp_path / "rt.bag")
    trosbag.write_bag(path, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
                      log.range_max, odoms=np.asarray(log.odoms))
    back = trosbag.read_bag(path)
    np.testing.assert_array_equal(back.ranges, log.ranges)
    np.testing.assert_allclose(back.timestamps, log.timestamps, atol=1e-6)
    assert back.angle_min == pytest.approx(log.angle_min, abs=1e-6)
    assert back.angle_increment == pytest.approx(log.angle_increment, abs=1e-9)
    assert back.range_max == pytest.approx(log.range_max, abs=1e-4)
    np.testing.assert_allclose(back.odoms, log.odoms, atol=1e-9)
    # The JAX package reads the port's bag to the same arrays, and its
    # writer's bytes are the port's.
    _assert_logs_equal(back, jrosbag.read_bag(path))
    jpath = str(tmp_path / "j.bag")
    jrosbag.write_bag(jpath, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
                      log.range_max, odoms=np.asarray(log.odoms))
    assert open(jpath, "rb").read() == open(path, "rb").read()


def test_bag_topic_selection_missing_and_compression(tmp_path):
    log = _small_log()
    path = str(tmp_path / "t.bag")
    trosbag.write_bag(path, log.ranges, log.timestamps, log.angle_min, log.angle_increment,
                      log.range_max, scan_topic="/front/scan")
    assert trosbag.read_bag(path, scan_topic="/front/scan").ranges.shape == log.ranges.shape
    with pytest.raises(IOError, match="no sensor_msgs/LaserScan"):
        trosbag.read_bag(path, scan_topic="/back/scan")
    bad = str(tmp_path / "bad.bag")
    open(bad, "wb").write(b"nope")
    with pytest.raises(IOError, match="not a ROS bag"):
        trosbag.read_bag(bad)
    import bz2

    raw = b"chunk bytes" * 10
    assert trosbag._decompress("bz2", bz2.compress(raw), len(raw)) == raw
    if importlib.util.find_spec("lz4") is None:
        with pytest.raises(IOError, match="'lz4'"):
            trosbag._decompress("lz4", b"", 0)


def test_csv_roundtrip(tmp_path):
    log = _small_log()
    path = str(tmp_path / "rt.csv")
    timporters.write_scan_csv(path, log.ranges, log.timestamps, log.angle_min,
                              log.angle_increment, log.range_max, odoms=np.asarray(log.odoms))
    back = timporters.load_log(path)
    np.testing.assert_allclose(back.ranges, log.ranges, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.odoms, log.odoms, atol=1e-12)
    assert back.angle_increment == pytest.approx(log.angle_increment)
    _assert_logs_equal(back, jimporters.read_scan_csv(path))
    bare = str(tmp_path / "bare.csv")
    timporters.write_scan_csv(bare, log.ranges, log.timestamps, log.angle_min,
                              log.angle_increment, log.range_max)
    _assert_logs_equal(timporters.read_scan_csv(bare), jimporters.read_scan_csv(bare))


def test_ndtlog_matches_the_native_reader(tmp_path):
    """A log the native runtime wrote, read by the port's numpy reader: every
    array and every header field bit for bit against the runtime's reader;
    a bad magic and a truncated payload raise."""
    log = jsynth.make_log(seed=8, n_scans=6, n_beams=90, world_size=40.0, odom_noise=0.02)
    path = str(tmp_path / "log.ndtlog")
    native.scanlog_write(path, log.ranges, log.poses, log.odoms, log.timestamps,
                         log.angle_min, log.angle_increment, log.range_max)
    want = native.scanlog_read(path)
    _assert_logs_equal(timporters.read_ndtlog(path), want)
    _assert_logs_equal(timporters.load_log(path), want)
    blob = open(path, "rb").read()
    bad = tmp_path / "bad.ndtlog"
    bad.write_bytes(b"NDTLOG2\0" + blob[8:])
    with pytest.raises(IOError, match="magic"):
        timporters.read_ndtlog(str(bad))
    bad.write_bytes(blob[:-8])
    with pytest.raises(IOError, match="truncated"):
        timporters.read_ndtlog(str(bad))


def _slice(log, n):
    return log._replace(ranges=log.ranges[:n], poses=log.poses[:n], odoms=log.odoms[:n],
                        timestamps=log.timestamps[:n])


def test_fixture_end_to_end_slam():
    """Mirror of tests/test_realdata.py::test_fixture_end_to_end_slam on the
    port's node (CPU): track the ground truth through noise, dropout and
    moving clutter (max error < 0.3 m), and end closer to it than the
    drifting odometry."""
    log = timporters.load_log(FIXTURE)
    gt = np.load(FIXTURE_GT)
    node = SlamNode(NodeConfig(**REAL, init_pose=tuple(log.odoms[0])), verbose=False,
                    device="cpu")
    poses = node.run_log(log)
    err = np.hypot(poses[:, 0] - gt[:, 0], poses[:, 1] - gt[:, 1])
    odo_err = np.hypot(log.odoms[:, 0] - gt[:, 0], log.odoms[:, 1] - gt[:, 1])
    assert err.max() < 0.3, f"realistic-data trajectory error {err.max():.3f} m"
    assert err[-1] < odo_err[-1], "SLAM should end closer to truth than odometry"


def test_fixture_first_scans_match_jax():
    """The first 8 scans of the bag through the port's node and the JAX
    node at the same configuration: poses within the parity tolerance."""
    from ndtpso_slam_tpu.node import NodeConfig as JNodeConfig, SlamNode as JSlamNode

    log = _slice(timporters.load_log(FIXTURE), 8)
    kw = dict(REAL, init_pose=tuple(float(v) for v in log.odoms[0]))
    jp = JSlamNode(JNodeConfig(**kw), verbose=False).run_log(log)
    tp = SlamNode(NodeConfig(**kw), verbose=False, device="cpu").run_log(log)
    np.testing.assert_allclose(tp, jp, atol=TRAJ_ATOL)
