"""Streaming multi-session scheduler: B live SLAM sessions on one GPU.

Port of ``ndtpso_slam_tpu/parallel/sessions.py``.  The reference scales to
several sensors by launching one OS process per LiDAR with remapped topics,
each consuming its own scan stream at its own rate
(``launch/lidar_front.launch:2,11-14``, ``launch/lidar_back.launch``).  A
:class:`SlamSessionPool` holds B independent session states stacked on a
leading robot axis (``models/slam.py:init_slam_batch``) and advances, at
each :meth:`~SlamSessionPool.poll`, every session with a queued scan;
idle sessions keep their state.  Arrival patterns are arbitrary (two LiDARs
at different rates, dropouts, a robot joining late).

Session b's key is threefry2x32(base_key_b, step_b, 0) from its own step
counter, the stream ``run_offline`` uses, so with recovery off a pooled
session replays a solo ``run_offline`` of its log bit for bit
(tests/test_torch_sessions.py).  With recovery on, a lost robot of the flat
step is relocalized by host escalation (``parallel/fleet.py``), which is
not the solo step's in-step branch: the JAX package's docstring claims
bit-for-bit replay there too, which does not hold (ROADMAP R4); the pool
ports the behavior, escalation with no backoff included.

Pools without the occupancy raster step through the flat fleet
(``fleet.fleet_pool_step``: one kernel launch for the solves of a
``rollout*`` mode, one flat map update); raster pools run the solo step per
active session on its views (:func:`pool_step`).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from ndtpso_slam_tpu_torch.config import SlamConfig, resolve_device
from ndtpso_slam_tpu_torch.models import slam as slam_mod
from ndtpso_slam_tpu_torch.models.scan import Scan
from ndtpso_slam_tpu_torch.ops import rng
from ndtpso_slam_tpu_torch.parallel.fleet import fleet_pool_step, relocalize_fleet_robot


def pool_step(states: slam_mod.SlamState, scans: Scan, base_keys, active, cfg: SlamConfig):
    """One masked step over the whole pool, in place: the solo ``slam_step``
    on each active session's views (every option of the solo step, the
    raster included), key threefry2x32(base_key_b, step_b, 0); inactive
    sessions keep their state.  Returns (states, poses [B, 3], costs [B]),
    an inactive session's pose its current one and its cost 0."""
    keys = np.asarray(base_keys, np.int64).reshape(-1, 2)
    poses = states.pose.clone()
    costs = torch.zeros(poses.shape[0], dtype=poses.dtype, device=poses.device)
    for i in np.nonzero(np.asarray(active, bool))[0]:
        st = slam_mod.session_state(states, i)
        st, poses[i], costs[i] = slam_mod.slam_step(
            st, Scan(points=scans.points[i], valid=scans.valid[i]),
            rng.derive_key(keys[i], st.step), cfg)
        slam_mod.set_session_state(states, i, st)
    return states, poses, costs


class SlamSessionPool:
    """B live SLAM sessions multiplexed onto one GPU.

    Args:
      cfg: the sessions' shared config (per-sensor values that do not change
        shapes, such as mount transforms, are applied when a scan is loaded,
        as the reference's node does, ``ndtframe.cpp:174-177``).
      initial_poses: [B, 3], one start pose per session.
      base_keys: [B, 2] u32 words, one random stream per session (a solo
        ``run_offline`` with the same key replays the session).
      device: where the sessions' states live (default ``"cuda"``).
    """

    def __init__(self, cfg: SlamConfig, initial_poses, base_keys, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        poses = np.asarray(initial_poses, np.float32).reshape(-1, 3)
        self.n_sessions = poses.shape[0]
        keys = np.asarray(base_keys, np.int64)
        assert keys.shape == (self.n_sessions, 2)
        self.base_keys = keys & 0xFFFFFFFF
        # The flat fleet for every config it runs; raster pools step each
        # session through the solo step (the flat step does not raster).
        self._use_flat = not cfg.og.enabled
        self.states = slam_mod.init_slam_batch(cfg, poses, self.device)
        self._queues: List[deque] = [deque() for _ in range(self.n_sessions)]
        n = cfg.scan.max_beams
        self._dummy = Scan(points=torch.zeros((n, 2), dtype=cfg.dtype, device=self.device),
                           valid=torch.zeros(n, dtype=torch.bool, device=self.device))

    def submit(self, session: int, scan: Scan) -> None:
        """Queue a loaded scan (``models/scan.py:load_laser``) for a session."""
        self._queues[session].append(scan)

    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    def poll(self) -> Dict[int, Tuple[np.ndarray, float]]:
        """One step: advance every session with a queued scan.  Returns
        {session: (pose [3], cost)} for the sessions that advanced (empty if
        nothing was pending)."""
        active = np.array([len(q) > 0 for q in self._queues])
        if not active.any():
            return {}
        taken = [q.popleft() if q else self._dummy for q in self._queues]
        scans = Scan(points=torch.stack([s.points for s in taken]),
                     valid=torch.stack([s.valid for s in taken]))
        if self._use_flat:
            self.states, poses, costs, lost = fleet_pool_step(
                self.states, scans, self.base_keys, active, self.cfg)
            # Host escalation of each robot the step flagged lost (only with
            # recovery on): the solo relocalization on its views, keyed by
            # the step's own key (the solo recovery branch reuses it too).
            for sid in np.nonzero(lost)[0]:
                key = rng.derive_key(self.base_keys[sid], self.states.step[sid] - 1)
                self.states, pose_i, cost_i, _ = relocalize_fleet_robot(
                    self.states, int(sid), taken[sid], key, self.cfg)
                poses[sid], costs[sid] = pose_i, cost_i
        else:
            self.states, poses, costs = pool_step(self.states, scans, self.base_keys, active,
                                                  self.cfg)
        poses_h, costs_h = poses.cpu().numpy(), costs.cpu().numpy()
        return {int(sid): (poses_h[sid], float(costs_h[sid])) for sid in np.nonzero(active)[0]}

    def drain(self) -> Dict[int, List[Tuple[np.ndarray, float]]]:
        """Poll until every queue is empty; per-session ordered results."""
        hist: Dict[int, List[Tuple[np.ndarray, float]]] = {i: [] for i in range(self.n_sessions)}
        while self.pending():
            for sid, res in self.poll().items():
                hist[sid].append(res)
        return hist

    def session_state(self, session: int) -> slam_mod.SlamState:
        """One session's state as a solo SlamState of views into the pool
        (for the export bundle or a checkpoint)."""
        return slam_mod.session_state(self.states, session)
