"""The benchmark's frozen copies give what their origins gave when they
were copied (``ndtpso_slam_tpu_torch/io/synthetic.py``; ``chip_smoke.py``'s
bound arithmetic, ``_score_bound`` included), recorded here so the test
outlives the origins."""

import math

import numpy as np
import pytest

import bench_small  # noqa: F401  (puts the benchmark on sys.path)
from ndtbench import roofline, synthetic


def test_world_and_raycast_as_recorded():
    w = synthetic.make_world(seed=3, size=50.0, n_boxes=6)
    assert w.shape == (28, 4)
    assert float(w.sum()) == pytest.approx(7.726072519294604, rel=1e-12)
    assert float((w ** 2).sum()) == pytest.approx(19394.00836559786, rel=1e-12)
    r = synthetic.raycast(w, np.array([8.0, 0.0, np.pi / 2]), 360, -np.pi, 2 * np.pi / 360, 30.0)
    assert int((r > 0).sum()) == 280
    assert float(r.sum()) == pytest.approx(5717.69161911379, rel=1e-12)
    assert float((r ** 2).sum()) == pytest.approx(129433.26489195263, rel=1e-12)
    tr = synthetic.circle_trajectory(np.arange(5) * 0.1, 8.0, 2 * np.pi / 42)
    assert float(tr.sum()) == pytest.approx(49.173081987209734, rel=1e-12)


def test_lap_log_closes_exactly():
    p = dict(world_size_m=50.0, n_boxes=6, world_shift_m=[0.137, 0.291], radius_m=8.0,
             lap_scans=420, dt_s=0.1, n_beams=360, range_max_m=30.0)
    lap = synthetic.lap_log(p, 2**31 + 5)
    assert lap.ranges.shape == (420, 360) and lap.ranges.dtype == np.float32
    b = lap.beams
    nxt = lap.poses[0] + np.array([0.0, 0.0, 2 * np.pi])  # pose 420, one lap on
    again = synthetic.raycast(lap.segments, nxt, b.n, b.angle_min, b.angle_increment, b.range_max)
    assert np.max(np.abs(again.astype(np.float32) - lap.ranges[0])) <= 1e-5
    step = np.hypot(*(lap.poses[1, :2] - lap.poses[0, :2]))
    assert step == pytest.approx(2 * 8.0 * math.sin(math.pi / 420), rel=1e-12)
    # The same seed gives the same traffic; another seed another world.
    assert np.array_equal(synthetic.lap_log(p, 2**31 + 5).ranges, lap.ranges)
    assert not np.array_equal(synthetic.lap_log(p, 2**31 + 6).ranges, lap.ranges)


def test_bound_arithmetic_as_recorded():
    assert roofline.bound(1e9, fp32=1e12, sfu=1e11) == (pytest.approx(23.91337618610346),
                                                          "operations")
    assert roofline.bound(1e12, fp32=1e9) == (pytest.approx(298.5074626865671), "bytes")
    assert roofline.score_ops(1000, 15) == {"fp32": 34000.0, "sfu": 1000.0}
    assert roofline.score_ops(1000, 15, "bf16", masked=False) == {
        "fp32": 3000.0, "sfu": 1000.0, "bf16": 30000.0}
    assert roofline.evaluations(50, [30]) == 1551
    assert roofline.evaluations(4096, [50] * 3) == 626691
    ms, by = roofline.rollout_local_bound(1, 384, 50, [30])
    assert (ms, by) == (pytest.approx(0.00022223283582089554, rel=1e-12), "operations")
    assert roofline.rollout_bound(256, 384, 4096, [50] * 256)[0] == pytest.approx(
        10.114456010507462, rel=1e-12)
    assert roofline.rollout_bound(16, 384, 4096, [50] * 16)[0] == pytest.approx(
        0.6321535006567164, rel=1e-12)
    assert roofline.rollout_bound(16, 384, 4096, [50] * 16, "bf16")[0] == pytest.approx(
        0.306919375573921, rel=1e-12)


def test_score_bound_as_recorded():
    # K3 at the relocalization's swarms (B = K = 8, N = 384, P = 128) and at
    # batch matching's fast_fused shape (B = 256, P = 4096): chip_smoke.py's
    # _score_bound on those tensors gave these.
    assert roofline.score_bound(8, 384, 128) == (pytest.approx(0.00019954244776119402,
                                                               rel=1e-12), "operations")
    assert roofline.score_bound(256, 384, 4096) == (pytest.approx(0.20433146650746267,
                                                                  rel=1e-12), "operations")
    # The swarms' global-best seed, one particle a swarm: bound by its bytes.
    assert roofline.score_bound(8, 384, 1) == (pytest.approx(5.8841791044776125e-05,
                                                             rel=1e-12), "bytes")
