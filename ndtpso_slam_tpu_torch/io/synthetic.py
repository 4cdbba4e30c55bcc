"""Synthetic 2-D LiDAR worlds: segment maps, raycast scans, trajectories.

A copy of ``ndtpso_slam_tpu/io/synthetic.py``, unchanged apart from this
docstring.  The port cannot import it from there: importing any module of the
JAX package imports JAX, and the GPU machine has none.  Both copies must make
the same logs from the same seeds (``tests/test_torch_slam.py`` checks it).

An axis-segment world, an exact raycaster, and smooth trajectories, so every
test and benchmark knows the true pose of every scan.  Pure NumPy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class ScanLog(NamedTuple):
    """A recorded (or synthesized) scan log with ground truth."""

    ranges: np.ndarray  # [T, B] float32, 0 where no return
    poses: np.ndarray  # [T, 3] ground-truth sensor poses
    odoms: np.ndarray  # [T, 3] noisy odometry poses
    timestamps: np.ndarray  # [T]
    angle_min: float
    angle_increment: float
    range_max: float


def box_segments(cx, cy, w, h) -> np.ndarray:
    """Axis-aligned box outline as 4 segments [4, 4] = (x1, y1, x2, y2)."""
    x0, x1 = cx - w / 2, cx + w / 2
    y0, y1 = cy - h / 2, cy + h / 2
    return np.array(
        [[x0, y0, x1, y0], [x1, y0, x1, y1], [x1, y1, x0, y1], [x0, y1, x0, y0]],
        dtype=np.float64,
    )


def make_world(seed: int = 0, size: float = 40.0, n_boxes: int = 6) -> np.ndarray:
    """A room with random interior boxes. Returns segments [M, 4]."""
    rs = np.random.RandomState(seed)
    segs = [box_segments(0, 0, size, size)]
    for _ in range(n_boxes):
        cx, cy = rs.uniform(-size * 0.35, size * 0.35, 2)
        w, h = rs.uniform(1.0, 4.0, 2)
        segs.append(box_segments(cx, cy, w, h))
    return np.concatenate(segs, axis=0)


def raycast(
    segments: np.ndarray,
    pose: np.ndarray,
    n_beams: int,
    angle_min: float,
    angle_increment: float,
    range_max: float,
) -> np.ndarray:
    """Exact ray-segment intersection ranges from one pose. [B] float64."""
    angles = pose[2] + angle_min + angle_increment * np.arange(n_beams)
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)  # [B, 2]
    o = pose[:2]
    p1 = segments[:, 0:2]
    e = segments[:, 2:4] - p1  # [M, 2]
    w = p1 - o  # [M, 2]
    # Solve o + t d = p1 + s e: cross products per (beam, segment).
    denom = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]  # [B, M]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (w[None, :, 0] * e[None, :, 1] - w[None, :, 1] * e[None, :, 0]) / denom
        s = (w[None, :, 0] * d[:, None, 1] - w[None, :, 1] * d[:, None, 0]) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-6) & (s >= 0.0) & (s <= 1.0)
    t = np.where(hit, t, np.inf)
    r = t.min(axis=1)
    return np.where(np.isfinite(r) & (r < range_max), r, 0.0)


def raycast_swept(
    segments: np.ndarray,
    pose0: np.ndarray,
    pose1: np.ndarray,
    n_beams: int,
    angle_min: float,
    angle_increment: float,
    range_max: float,
) -> np.ndarray:
    """Motion-distorted raycast: beam j fires from the pose interpolated a
    fraction j/B of the way from ``pose0`` to ``pose1``.

    A real spinning 2-D LiDAR sweeps its beams over ~the whole scan period
    while the robot keeps moving, so the scan is NOT a rigid snapshot — the
    classic "scan skew" every real recording has and a rigid raycaster
    can't produce.  [B] float64 ranges.
    """
    f = np.arange(n_beams, dtype=np.float64) / n_beams
    dpose = np.asarray(pose1, np.float64) - np.asarray(pose0, np.float64)
    dpose[2] = (dpose[2] + np.pi) % (2 * np.pi) - np.pi
    poses = np.asarray(pose0, np.float64)[None, :] + f[:, None] * dpose[None, :]
    angles = poses[:, 2] + angle_min + angle_increment * np.arange(n_beams)
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)  # [B, 2]
    o = poses[:, :2]  # [B, 2] per-beam origins
    p1 = segments[:, 0:2]
    e = segments[:, 2:4] - p1  # [M, 2]
    w = p1[None, :, :] - o[:, None, :]  # [B, M, 2]
    denom = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (w[..., 0] * e[None, :, 1] - w[..., 1] * e[None, :, 0]) / denom
        s = (w[..., 0] * d[:, None, 1] - w[..., 1] * d[:, None, 0]) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-6) & (s >= 0.0) & (s <= 1.0)
    t = np.where(hit, t, np.inf)
    r = t.min(axis=1)
    return np.where(np.isfinite(r) & (r < range_max), r, 0.0)


def circle_trajectory(t: np.ndarray, radius: float = 8.0, omega: float = 0.15):
    """Smooth loop: position on a circle, heading tangent."""
    a = omega * t
    return np.stack(
        [radius * np.cos(a), radius * np.sin(a), a + np.pi / 2], axis=-1
    )


def make_log(
    seed: int = 0,
    n_scans: int = 50,
    n_beams: int = 360,
    world_size: float = 40.0,
    range_max: float = 30.0,
    dt: float = 0.1,
    range_noise: float = 0.0,
    odom_noise: float = 0.0,
    trajectory: Optional[np.ndarray] = None,
    segments: Optional[np.ndarray] = None,
) -> ScanLog:
    """Synthesize a full scan log with ground truth and noisy odometry."""
    rs = np.random.RandomState(seed + 1)
    if segments is None:
        segments = make_world(seed, size=world_size)
    ts = np.arange(n_scans) * dt
    if trajectory is None:
        trajectory = circle_trajectory(ts)
    angle_min = -np.pi
    angle_increment = 2 * np.pi / n_beams
    ranges = np.zeros((n_scans, n_beams), np.float64)
    for i in range(n_scans):
        ranges[i] = raycast(
            segments, trajectory[i], n_beams, angle_min, angle_increment, range_max
        )
    if range_noise > 0:
        noise = rs.normal(0, range_noise, ranges.shape)
        ranges = np.where(ranges > 0, np.maximum(ranges + noise, 0.01), 0.0)
    odoms = trajectory + (
        rs.normal(0, odom_noise, trajectory.shape) if odom_noise > 0 else 0.0
    )
    return ScanLog(
        ranges=ranges.astype(np.float32),
        poses=trajectory.astype(np.float64),
        odoms=np.asarray(odoms, np.float64),
        timestamps=ts,
        angle_min=float(angle_min),
        angle_increment=float(angle_increment),
        range_max=float(range_max),
    )


def make_soak_world(seed: int = 0, length: float = 90.0,
                    half_width: float = 3.0) -> np.ndarray:
    """A warehouse-aisle corridor for long soaks: two long walls
    `2*half_width` apart with boxes/alcoves along them every few metres
    (longitudinal texture — a bare corridor is ambiguous along its axis) and
    end caps.  Walls stay 2-3 m from a patrolling robot the whole run, which
    is what pushes enough points through the near cells to rotate their
    100-slot sliding windows all the way around.  Returns segments [M, 4]."""
    rs = np.random.RandomState(seed)
    hl = length / 2
    segs = [
        np.array([[-hl, -half_width, hl, -half_width],
                  [-hl, half_width, hl, half_width],
                  [-hl, -half_width, -hl, half_width],
                  [hl, -half_width, hl, half_width]], np.float64)
    ]
    x = -hl + 4.0
    while x < hl - 4.0:
        for side in (-1.0, 1.0):
            if rs.rand() < 0.8:
                w = rs.uniform(0.4, 1.2)
                d = rs.uniform(0.3, 0.9)
                segs.append(box_segments(
                    x + rs.uniform(-1.0, 1.0),
                    side * (half_width - d / 2), w, d,
                ))
        x += rs.uniform(5.0, 9.0)
    return np.concatenate(segs, axis=0)


def make_soak_log(
    seed: int = 0,
    n_scans: int = 1200,
    n_beams: int = 360,
    range_max: float = 30.0,
    dt: float = 0.1,
    amplitude: float = 38.0,
) -> ScanLog:
    """Deployment-scale soak log: a dock dwell then one oval patrol lap of
    a warehouse aisle (stadium path ≈ 4·amplitude ≈ 152 m — the ≥150 m /
    1000+ scans regime of the reference's 300 m frame deployment,
    `ndtpso_slam_node.hpp:25-34`).  The dwell phase is what drives the
    sliding windows of the dock's wall cells around the full ring —
    the WRAP/eviction regime (`ndtcell.cpp:61-65` mod `config.h:8`'s 100)
    that short benches never reach; the lap phase exercises long-range
    traverse, the U-turns, and map reuse on return."""
    ts = np.arange(n_scans, dtype=np.float64)
    dwell = min(n_scans // 6, 400)
    # Phase 1 — dock dwell: the robot sits ~2 m from a wall for `dwell`
    # scans (boot/charge/inspection stop) with millimetre pose jitter.
    # This is what guarantees the ring WRAP: the near wall cells take
    # >capacity points every couple of scans, so their windows rotate
    # >window_slots times during the dwell alone — drive-by passes
    # physically cannot push 100 slots × 50 points through one 0.5 m cell.
    # Phase 2 — one oval patrol lap (stadium path, 4·amplitude ≈ 152 m).
    # The heading follows the exact velocity of the oval, so the heading
    # rate is continuous and never zero: the reference's adaptive search
    # radius (2·pose-diff, `ndtframe.cpp:253`) collapses on any trajectory
    # with a zero-motion dimension, and a U-turn entered from dθ = 0 is
    # invisible to the solver — an oval never does that to it.  (Both
    # failure modes were observed, not hypothesized: see the round-3 soak
    # probes.)
    b_axis = 1.5
    phi0 = np.pi / 4
    # Smoothstep lap progress: pulling away from the dock (and stopping at
    # the end) ramps the speed from zero, so the first motion step never
    # outruns the deviation learned from the dwell jitter.
    tau = np.clip((ts - dwell) / max(n_scans - 1 - dwell, 1), 0.0, 1.0)
    lap = tau * tau * (3.0 - 2.0 * tau)
    phi = phi0 + 2.0 * np.pi * lap
    x = amplitude * np.cos(phi)
    y = b_axis * np.sin(phi)
    # Dwell jitter (real robots are never bit-still; keeps deviation alive).
    jit = ts < dwell
    x = x + np.where(jit, 0.01 * np.sin(2 * np.pi * ts / 50.0), 0.0)
    y = y + np.where(jit, 0.008 * np.cos(2 * np.pi * ts / 37.0), 0.0)
    # Exact tangent heading of the oval (well-defined even while dwelling).
    heading = np.unwrap(
        np.arctan2(b_axis * np.cos(phi), -amplitude * np.sin(phi))
    )
    heading = heading + np.where(jit, 0.01 * np.sin(2 * np.pi * ts / 70.0), 0.0)
    traj = np.stack([x, y, heading], axis=-1)
    segs = make_soak_world(seed, length=2 * amplitude + 14.0)
    return make_log(
        seed=seed, n_scans=n_scans, n_beams=n_beams, range_max=range_max,
        dt=dt, trajectory=traj, segments=segs,
    )


def make_realistic_log(
    seed: int = 0,
    n_scans: int = 60,
    n_beams: int = 540,
    world_size: float = 40.0,
    range_max: float = 30.0,
    dt: float = 0.1,
    range_noise: float = 0.02,
    dropout: float = 0.05,
    odom_noise: float = 0.03,
    n_movers: int = 2,
    skew: bool = True,
) -> ScanLog:
    """A scan log with real-LiDAR failure modes the clean raycaster lacks:
    per-beam Gaussian range noise, random beam dropout (specular surfaces /
    max-range misses return 0), dynamic clutter — boxes that move between
    scans, so some returns are never explainable by the static map — and
    motion distortion (``skew``): each beam fires from the pose the moving
    robot actually occupied at that beam's firing time within the sweep
    (:func:`raycast_swept`), so no rigid transform maps the scan onto the
    map exactly.  This is the fixture-generation path for end-to-end tests
    against realistic data when no recorded dataset can be bundled (this
    build environment has no network egress and ships no public rosbag —
    see PARITY.md "real recorded data").
    """
    rs = np.random.RandomState(seed + 17)
    static = make_world(seed, size=world_size)
    ts = np.arange(n_scans) * dt
    trajectory = circle_trajectory(ts)
    angle_min = -np.pi
    angle_increment = 2 * np.pi / n_beams
    # Dynamic boxes: random walks inside the room.
    mover_pos = rs.uniform(-world_size * 0.3, world_size * 0.3, (n_movers, 2))
    mover_vel = rs.uniform(-0.5, 0.5, (n_movers, 2))
    mover_wh = rs.uniform(0.4, 1.0, (n_movers, 2))
    ranges = np.zeros((n_scans, n_beams), np.float64)
    for i in range(n_scans):
        segs = [static]
        for m in range(n_movers):
            segs.append(
                box_segments(mover_pos[m, 0], mover_pos[m, 1],
                             mover_wh[m, 0], mover_wh[m, 1])
            )
        mover_pos = mover_pos + mover_vel * dt
        if skew:
            nxt = trajectory[i + 1] if i + 1 < n_scans else (
                2 * trajectory[i] - trajectory[i - 1]
            )
            ranges[i] = raycast_swept(
                np.concatenate(segs, axis=0), trajectory[i], nxt, n_beams,
                angle_min, angle_increment, range_max,
            )
        else:
            ranges[i] = raycast(
                np.concatenate(segs, axis=0), trajectory[i], n_beams,
                angle_min, angle_increment, range_max,
            )
    noise = rs.normal(0, range_noise, ranges.shape)
    ranges = np.where(ranges > 0, np.maximum(ranges + noise, 0.01), 0.0)
    drop = rs.rand(*ranges.shape) < dropout
    ranges = np.where(drop, 0.0, ranges)
    odoms = trajectory + np.cumsum(
        rs.normal(0, odom_noise * dt, trajectory.shape), axis=0
    )  # drifting odometry, like a real wheel encoder
    return ScanLog(
        ranges=ranges.astype(np.float32),
        poses=trajectory.astype(np.float64),
        odoms=np.asarray(odoms, np.float64),
        timestamps=ts,
        angle_min=float(angle_min),
        angle_increment=float(angle_increment),
        range_max=float(range_max),
    )
