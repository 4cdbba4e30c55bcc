"""The benchmark's traffic generator: synthetic 2-D LiDAR worlds and logs.

``box_segments``, ``make_world``, ``raycast`` and ``circle_trajectory`` are
frozen copies of ``ndtpso_slam_tpu_torch/io/synthetic.py`` (itself a copy of
the JAX package's), so the benchmark's traffic cannot move when the program
changes; ``tests/test_bench_frozen.py`` holds them to the values the origin
gave when they were copied.  The two generators below read a traffic mix's
parameters (a file under ``traffic/``):

* :func:`lap_log`: a lap-exact patrol for the SLAM node, one lap of
  ``lap_scans`` scans on a circle, so the window can replay it lap after lap
  without a jump in the trajectory;
* :func:`pair_pool`: a pool of independent scan pairs for batch matching,
  each a map built from jittered re-observations of a reference scan and a
  query scan from a known offset.

The node's traffic is a lap and a :class:`Schedule`, the lap index played at
each step, made by the generator that the traffic's ``kind`` names in
:data:`NODE_TRAFFIC`: ``lap_log`` replays the lap in order, ``kidnap_log``
carries the robot ahead along it now and then (:func:`kidnap_log`).

Pure NumPy.  Every draw comes from ``numpy.random.default_rng(seed)``, which
takes any non-negative seed (``RandomState`` stops at 2**32).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np


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


def circle_trajectory(t: np.ndarray, radius: float = 8.0, omega: float = 0.15):
    """Smooth loop: position on a circle, heading tangent."""
    a = omega * t
    return np.stack(
        [radius * np.cos(a), radius * np.sin(a), a + np.pi / 2], axis=-1
    )


def world_seed(rng: np.random.Generator) -> int:
    """A ``make_world`` seed (below 2**31) drawn from ``rng``."""
    return int(rng.integers(0, 2**31))


def shifted_world(rng: np.random.Generator, size: float, n_boxes: int, shift) -> np.ndarray:
    """``make_world`` with a seed from ``rng``, moved by ``shift`` [2] metres,
    so the room's walls do not lie on the map's cell borders."""
    segs = make_world(world_seed(rng), size=size, n_boxes=n_boxes)
    return segs + np.tile(np.asarray(shift, np.float64), 2)


class Beams(NamedTuple):
    """A scanner's beam geometry (the scan message's metadata)."""

    n: int
    angle_min: float
    angle_increment: float
    range_max: float


def beams_of(p: dict) -> Beams:
    n = int(p["n_beams"])
    return Beams(n, -math.pi, 2 * math.pi / n, float(p["range_max_m"]))


class LapLog(NamedTuple):
    """One lap of a patrol: ranges [L, n] float32, true sensor poses [L, 3],
    the scan period, the beam geometry and the world's segments."""

    ranges: np.ndarray
    poses: np.ndarray
    dt: float
    beams: Beams
    segments: np.ndarray


def lap_log(p: dict, seed: int) -> LapLog:
    """A lap-exact circular patrol (traffic kind ``lap_log``): the world is
    ``make_world`` of ``world_size_m`` with ``n_boxes`` boxes, moved by
    ``world_shift_m``; the sensor runs a circle of ``radius_m`` at the rate
    that closes it in exactly ``lap_scans`` scans of ``dt_s``, so scan
    ``lap_scans`` equals scan 0 and a replay has no jump."""
    rng = np.random.default_rng(seed)
    segs = shifted_world(rng, float(p["world_size_m"]), int(p["n_boxes"]), p["world_shift_m"])
    lap, dt = int(p["lap_scans"]), float(p["dt_s"])
    omega = 2 * math.pi / (lap * dt)
    poses = circle_trajectory(np.arange(lap) * dt, float(p["radius_m"]), omega)
    b = beams_of(p)
    ranges = np.stack([raycast(segs, poses[i], b.n, b.angle_min, b.angle_increment,
                               b.range_max) for i in range(lap)])
    return LapLog(ranges.astype(np.float32), poses, dt, b, segs)


class Schedule:
    """The lap index played at each step of a node's run: ``t mod L`` through
    the ``warmup`` steps; in the window (step ``warmup`` + w) the index
    advances by 1, and at every ``every``-th window scan (w = every - 1,
    2·every - 1, ...) by an extra jump drawn uniformly from ``jumps``
    (inclusive) by ``rng``.  ``every`` 0: no jumps, ``t mod L`` at every
    step.  Jumps are drawn in blocks of a fixed size, so a seed gives the
    same schedule however far it is read."""

    BLOCK = 1024

    def __init__(self, lap: int, warmup: int, every: int = 0, jumps=(0, 0),
                 rng: Optional[np.random.Generator] = None):
        self.lap, self.warmup, self.every = int(lap), int(warmup), int(every)
        self.lo, self.hi = int(jumps[0]), int(jumps[1])
        if self.every < 0 or not 0 <= self.lo <= self.hi:
            raise ValueError(f"bad schedule: every {every}, jumps {jumps}")
        self.rng = rng
        self.offsets = np.zeros(1, np.int64)  # offsets[j]: the first j jumps summed

    def _events(self, t: int) -> int:
        """Jumps made up to and including step t."""
        w = t - self.warmup
        return 0 if self.every == 0 or w < 0 else (w + 1) // self.every

    def index(self, t: int) -> int:
        j = self._events(t)
        while j >= len(self.offsets):
            block = self.rng.integers(self.lo, self.hi + 1, self.BLOCK)
            self.offsets = np.concatenate([self.offsets, self.offsets[-1] + np.cumsum(block)])
        return int((t + self.offsets[j]) % self.lap)

    def kidnaps(self, lo: int, hi: int) -> List[int]:
        """The steps in [lo, hi) at which the robot is carried ahead."""
        if self.every == 0:
            return []
        first = self.warmup + self.every - 1
        start = max(lo, first)
        start += (first - start) % self.every
        return list(range(start, hi, self.every))


class NodeFeed(NamedTuple):
    lap: LapLog
    schedule: Schedule


def lap_feed(p: dict, seed: int) -> NodeFeed:
    """``lap_log``'s lap replayed in order (traffic kind ``lap_log``)."""
    lap = lap_log(p, seed)
    n = lap.ranges.shape[0]
    return NodeFeed(lap, Schedule(n, int(p["warmup_laps"]) * n))


def kidnap_log(p: dict, seed: int) -> NodeFeed:
    """``lap_log``'s lap, exactly as it makes it, played with kidnaps
    (traffic kind ``kidnap_log``): the warm-up laps in order, so the whole
    map is built first; then at every ``kidnap_every``-th window scan the
    robot is carried a further ``jump_scans`` = [lo, hi] scans along the lap,
    drawn uniformly by a generator of its own from the seed (``lap_log``'s
    draws are left as they are)."""
    lap = lap_log(p, seed)
    n = lap.ranges.shape[0]
    return NodeFeed(lap, Schedule(n, int(p["warmup_laps"]) * n, int(p["kidnap_every"]),
                                  p["jump_scans"], np.random.default_rng([seed, 0x6B1D])))


# The node's traffic generators, by the traffic's ``kind``.
NODE_TRAFFIC = {"lap_log": lap_feed, "kidnap_log": kidnap_log}


class PairPool(NamedTuple):
    """Independent scan pairs (traffic kind ``pairs``): ``pool`` pairs, each
    reading world ``world[i]`` of ``maps`` (the jittered reference points
    [W, S, n, 2] float32 a map is built from, S observations) with a query
    scan's ranges [pool, n] float32 taken from the true offset ``true[i]``."""

    ref_points: np.ndarray
    ref_valid: np.ndarray  # [W, n] bool
    world: np.ndarray  # [pool] int
    query_ranges: np.ndarray
    true: np.ndarray  # [pool, 3]
    beams: Beams


def pair_pool(p: dict, seed: int) -> PairPool:
    """``pool`` scan pairs over ``worlds`` seeded worlds, as ``bench.py``
    builds one batch (bench.py:232-292): each world's reference scan from the
    origin, re-observed ``ref_scans`` times with N(0, ``ref_jitter_m``) on
    every point; each pair's query scan from a true offset drawn uniformly
    within ±``offset``."""
    rng = np.random.default_rng(seed)
    b = beams_of(p)
    n_worlds, pool = int(p["worlds"]), int(p["pool"])
    shifts = rng.uniform(0.0, 1.0, (n_worlds, 2))
    worlds = [shifted_world(rng, float(p["world_size_m"]), int(p["n_boxes"]), shifts[w])
              for w in range(n_worlds)]
    bearings = np.stack([np.cos(b.angle_min + b.angle_increment * np.arange(b.n)),
                         np.sin(b.angle_min + b.angle_increment * np.arange(b.n))], -1)
    ref_points, ref_valid = [], []
    for segs in worlds:
        r = raycast(segs, np.zeros(3), b.n, b.angle_min, b.angle_increment, b.range_max)
        pts = r[:, None] * bearings
        jit = rng.normal(0.0, float(p["ref_jitter_m"]), (int(p["ref_scans"]), b.n, 2))
        ref_points.append(pts[None] + jit)
        ref_valid.append((r > 0.1) & (r < b.range_max))  # loadLaser's range filter
    off = np.asarray(p["offset"], np.float64)
    true = rng.uniform(-off, off, (pool, 3))
    world = rng.integers(0, n_worlds, pool)
    query = np.stack([raycast(worlds[world[i]], true[i], b.n, b.angle_min, b.angle_increment,
                              b.range_max) for i in range(pool)])
    return PairPool(np.asarray(ref_points, np.float32), np.asarray(ref_valid), world,
                    query.astype(np.float32), true, b)
