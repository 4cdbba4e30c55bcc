"""The port's node shell against tests/test_node.py, on the CPU: the export
bundle (file names, row counts, and the files themselves against the JAX
package's export of the same state and point cloud), checkpoint and resume
(dense and sparse ring, bit for bit), checkpoint validation, GLIR in the
node, the CLI end to end on a ``.bag`` with ``--checkpoint``/``--resume``,
the launch JSONs, and the buffered logger.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ndtpso_slam_tpu.io import synthetic as jsynth

from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode, main
from ndtpso_slam_tpu_torch.utils import export as texport
from ndtpso_slam_tpu_torch.utils.state import slam_state_from_numpy, slam_state_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_node.py's configuration.
SMALL = dict(frame_size_m=48.0, cell_side_m=1.0, window_slots=8, max_beams=360,
             pso_iterations=25, pso_population=50, cost_mode="exact", save_every=2)
EXPORT = dict(build_og=True, og_cell_size_m=0.25, save_map_images=True)


@pytest.fixture(scope="module")
def log():
    return jsynth.make_log(seed=8, n_scans=12, n_beams=360, world_size=40.0, odom_noise=0.02)


@pytest.fixture(scope="module")
def jax_export(log, tmp_path_factory):
    """The JAX node over the log at SMALL + EXPORT, and its export bundle:
    (node, directory, the files written there under the basename "run")."""
    from ndtpso_slam_tpu.node import NodeConfig as JNodeConfig, SlamNode as JSlamNode

    jnode = JSlamNode(JNodeConfig(**SMALL, init_pose=tuple(log.poses[0]), **EXPORT),
                      verbose=False)
    jnode.run_log(log)
    out = tmp_path_factory.mktemp("jax_export")
    return jnode, out, jnode.shutdown(str(out / "run"))


def _feed(node, log, steps):
    return np.array([node.process_scan(log.ranges[i], log.angle_min, log.angle_increment,
                                       log.range_max, timestamp=float(log.timestamps[i]),
                                       odom=log.odoms[i]) for i in steps])


def _names(files):
    return sorted(os.path.basename(f) for f in files)


def test_node_tracks_and_exports(log, jax_export, tmp_path):
    """Mirror of tests/test_node.py::test_node_tracks_and_exports: the node
    tracks and its shutdown writes the whole bundle, under the JAX node's
    file names, with one pose row per scan.  (The two nodes' maps are not
    compared here: this world's walls lie on the 1 m cell borders, where
    the two packages' sin/cos, an ulp apart, bin some points into
    neighbouring cells from the first scan on; the next test compares the
    exports of one state.)"""
    kw = dict(SMALL, init_pose=tuple(log.poses[0]), **EXPORT)
    node = SlamNode(NodeConfig(**kw), verbose=False, device="cpu")
    received = []
    node.on_pose(lambda ts, pose: received.append((ts, pose)))
    poses = node.run_log(log)
    assert len(received) == 12
    err = np.hypot(*(poses[:, :2] - log.poses[:, :2]).T)
    assert err.max() < 0.2, f"node tracking error {err.max():.3f}"
    assert node.meter.average_rate_hz > 0
    files = node.shutdown(str(tmp_path / "run"))
    assert _names(files) == _names(jax_export[2])
    names = _names(files)
    assert {"run.pose.csv", "run.map.csv", "run.gnuplot", "run.cells.csv"} <= set(names)
    assert any("occupancy-grid.png" in n for n in names) and any("ppm.png" in n for n in names)
    lines = open(tmp_path / "run.pose.csv").read().strip().split("\n")
    assert len(lines) == 13 and len(lines[1].split(",")) == 7
    assert len(open(tmp_path / "run.map.csv").read().split("\n")) > 100
    assert len(open(tmp_path / "run.cells.csv").read().split("\n")) > 30


def test_export_matches_jax_export_of_the_same_state(log, jax_export, tmp_path):
    """The JAX node's final state and point cloud exported by both packages:
    the pose and map CSVs and the gnuplot script byte for byte, the map and
    occupancy-grid PNGs equal pixel for pixel after decoding, and the cells
    CSV within 1e-5."""
    from test_torch_slam import _jax_state_to_numpy

    jnode, jdir, jfiles = jax_export
    kw = dict(SMALL, init_pose=tuple(log.poses[0]), **EXPORT)
    node = SlamNode(NodeConfig(**kw), verbose=False, device="cpu")
    node.state = slam_state_from_numpy(_jax_state_to_numpy(jnode.state), node.slam_cfg, "cpu")
    gm = jnode.global_map
    node.global_map._points, node.global_map._poses = list(gm._points), list(gm._poses)
    node.global_map._odoms, node.global_map._timestamps = list(gm._odoms), list(gm._timestamps)
    files = node.shutdown(str(tmp_path / "run"))
    assert _names(files) == _names(jfiles)
    for f in files:
        name = os.path.basename(f)
        other = jdir / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(texport.read_png(f), texport.read_png(str(other)),
                                          err_msg=name)
        elif name.endswith(".cells.csv"):
            got, want = (np.loadtxt(p, delimiter=",", skiprows=1) for p in (f, other))
            assert got.shape == want.shape and got.shape[0] > 30
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert open(f).read() == open(other).read(), name


def _resume_exact(log, tmp_path, cfg):
    """A node checkpointed after 6 scans, restored into a fresh node: the
    state round-trips bit for bit, and the restored node's next 6 poses
    equal those of the node that saved it and ran on."""
    node = SlamNode(cfg, verbose=False, device="cpu")
    _feed(node, log, range(6))
    ckpt = str(tmp_path / "mid.npz")
    node.save_checkpoint(ckpt)
    resumed = SlamNode(cfg, verbose=False, device="cpu")
    resumed.load_checkpoint(ckpt)
    a, b = slam_state_to_numpy(node.state), slam_state_to_numpy(resumed.state)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(_feed(resumed, log, range(6, 12)),
                                  _feed(node, log, range(6, 12)))
    return resumed


def test_checkpoint_resume_exact(log, tmp_path):
    _resume_exact(log, tmp_path, NodeConfig(**SMALL, init_pose=tuple(log.poses[0])))


def test_checkpoint_resume_exact_sparse_ring(log, tmp_path):
    """A sparse ring's cell-to-row table is state: resume is exact only if
    ring_map / ring_used travel with the checkpoint."""
    node = _resume_exact(log, tmp_path, NodeConfig(**SMALL, init_pose=tuple(log.poses[0]),
                                                   ring_rows=512))
    assert int(node.state.map.ring_used) > 0 and node.state.map.slot_sum.shape[0] == 513


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    """A checkpoint restored into a state of another configuration is
    refused, naming the key: another frame size, a sparse ring, an
    occupancy grid; a tampered dtype and a missing key too."""
    node = SlamNode(NodeConfig(**SMALL), verbose=False, device="cpu")
    ckpt = str(tmp_path / "a.npz")
    node.save_checkpoint(ckpt)
    for over, key in ((dict(frame_size_m=32.0), "map.built"), (dict(ring_rows=64), "map.ring_map"),
                      (dict(build_og=True), "og.")):
        other = SlamNode(NodeConfig(**{**SMALL, **over}), verbose=False, device="cpu")
        with pytest.raises(ValueError, match=key):
            other.load_checkpoint(ckpt)
    with np.load(ckpt) as d:
        arrays = dict(d)
    desc = json.loads(bytes(arrays["__descriptor__"]).decode())
    desc["arrays"]["map.g_count"]["dtype"] = "<f4"
    tampered = dict(arrays, **{"map.g_count": arrays["map.g_count"].astype(np.float32),
                               "__descriptor__": np.frombuffer(json.dumps(desc).encode(),
                                                               np.uint8)})
    np.savez(str(tmp_path / "b.npz"), **tampered)
    with pytest.raises(ValueError, match="map.g_count"):
        node.load_checkpoint(str(tmp_path / "b.npz"))
    del arrays["pose"]
    np.savez(str(tmp_path / "c.npz"), **arrays)
    with pytest.raises(ValueError, match="'pose'"):
        node.load_checkpoint(str(tmp_path / "c.npz"))


def test_glir_optimizer_tracks(log):
    """Mirror of tests/test_node.py::test_glir_optimizer_tracks: GLIR runs
    the whole session and stays on the map (a plausibility gate)."""
    node = SlamNode(NodeConfig(**{**SMALL, "optimizer": "glir"}, init_pose=tuple(log.poses[0])),
                    verbose=False, device="cpu")
    poses = node.run_log(log)
    err = np.hypot(*(poses[:, :2] - log.poses[:, :2]).T)
    assert np.isfinite(poses).all()
    assert err.max() < 1.0, f"glir tracking error {err.max():.3f}"


@pytest.mark.parametrize("mode", ["rollout", "rollout_local"])
def test_glir_rejects_rollout_modes(mode):
    with pytest.raises(ValueError, match="rollout"):
        SlamNode(NodeConfig(**{**SMALL, "optimizer": "glir", "cost_mode": mode,
                               "max_beams": 384}), verbose=False, device="cpu")


# The CLI runs below: NodeConfig's defaults with these.
CLI = dict(frame_size_m=48.0, cell_side_m=1.0, pso_iterations=20, pso_population=40,
           cost_mode="exact")


def _cli(tmp_path, bag, out, *extra):
    cmd = [sys.executable, "-m", "ndtpso_slam_tpu_torch.node", "--device", "cpu",
           "--scanlog", bag, "--out", str(tmp_path / out), "--quiet", "--frame-size", "48",
           "--cell-side", "1", "--iterations", "20", "--population", "40",
           "--cost-mode", "exact", *extra]
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    return np.loadtxt(tmp_path / f"{out}.pose.csv", delimiter=",", skiprows=1, ndmin=2)


def test_cli_checkpoint_resume_on_a_bag(log, tmp_path):
    """The CLI end to end on .bag logs: the log as two halves, the second
    resumed from the first's --checkpoint: the resumed half's pose rows
    equal those of one uninterrupted node over the whole log, written by
    its own shutdown; the bundle is written; --checkpoint with a repeated
    --scanlog (several sessions) is refused: checkpoints are single-session."""
    from ndtpso_slam_tpu_torch.io.importers import load_log
    from ndtpso_slam_tpu_torch.io.rosbag import write_bag

    def bag(name, sl):
        path = str(tmp_path / name)
        write_bag(path, log.ranges[sl], log.timestamps[sl], log.angle_min,
                  log.angle_increment, log.range_max, odoms=np.asarray(log.odoms[sl]))
        return path

    whole = SlamNode(NodeConfig(**CLI), verbose=False, device="cpu")
    whole.run_log(load_log(bag("all.bag", slice(None))))
    whole.shutdown(str(tmp_path / "all"))
    rows = np.loadtxt(tmp_path / "all.pose.csv", delimiter=",", skiprows=1, ndmin=2)
    assert rows.shape == (12, 7)
    first = _cli(tmp_path, bag("a.bag", slice(0, 6)), "a", "--checkpoint", str(tmp_path / "a.npz"))
    rest = _cli(tmp_path, bag("b.bag", slice(6, 12)), "b", "--resume", str(tmp_path / "a.npz"))
    np.testing.assert_array_equal(np.concatenate([first, rest]), rows)
    for suffix in (".map.csv", ".gnuplot", ".cells.csv"):
        assert os.path.getsize(tmp_path / f"b{suffix}") > 0
    with pytest.raises(SystemExit):
        main(["--scanlog", "x.bag", "--scanlog", "y.bag", "--checkpoint", "z.npz",
              "--device", "cpu"])


def test_node_config_json_and_launch_files(tmp_path):
    path = str(tmp_path / "cfg.json")
    json.dump({"frame_size_m": 64.0, "pso_iterations": 7, "ring_rows": 128,
               "prefer_frontal_points": True}, open(path, "w"))
    cfg = NodeConfig.from_json(path, pso_population=11)
    assert (cfg.frame_size_m, cfg.pso_iterations, cfg.pso_population) == (64.0, 7, 11)
    assert cfg.slam_config().map.ring_rows == 128 and cfg.slam_config().scan.prefer_frontal_points
    json.dump({"bogus_key": 1}, open(path, "w"))
    with pytest.raises(ValueError, match="bogus_key"):
        NodeConfig.from_json(path)
    for name in ("scan.json", "lidar_front.json", "lidar_back.json"):
        raw = json.load(open(os.path.join(REPO, "launch", name)))
        raw.pop("_comment", None)
        cfg = NodeConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()})
        assert cfg.frame_size_m > 0


def test_buffered_logger_flushes(tmp_path):
    """BufferedLogger (the reference's logger.cpp): nothing reaches the file
    before buffer_lines lines, each full buffer and close flush; the global
    logger writes nothing until init."""
    from ndtpso_slam_tpu_torch.utils import logger

    path = tmp_path / "log.txt"
    lg = logger.BufferedLogger(str(path), buffer_lines=3)
    lg.write("a")
    lg.write("b\n")
    assert path.read_text() == ""
    lg.write("c")
    assert path.read_text() == "a\nb\nc\n"
    lg.write("d")
    lg.close()
    assert path.read_text() == "a\nb\nc\nd\n"
    logger.write("dropped")
    logger.init(str(tmp_path / "g.txt"), buffer_lines=50)
    logger.write("kept")
    logger.close()
    assert (tmp_path / "g.txt").read_text() == "kept\n"
