"""The flat fleet: B SLAM sessions stepped together, the robot axis folded
into the cell axis.

Port of ``ndtpso_slam_tpu/parallel/fleet.py``.  A stacked state
(``models/slam.py:init_slam_batch``) keeps robot b's map in rows
``b·(C+1) … b·(C+1) + C`` of each per-cell field viewed flat as
``[B·(C+1), …]`` (and ``b·(R+1) …`` of a sparse ring's ``[B·(R+1), S, …]``),
so one update over flat ids ``b·(C+1) + id`` writes every robot's cells, and
a dropped id goes to robot b's own spare row: no global sentinel.  That
update is ``ndt_map.add_points_stacked``/``build_touched_stacked``, whose
one-map case is the solo ``add_points``/``build_touched``, so per robot the
arithmetic runs on the same rows in the same order and each robot
reproduces its solo ``run_offline`` bit for bit.

* The solves of a ``rollout*`` cost mode are ONE launch of the whole-solve
  kernel (K1 ``rollout_local[_turbo]`` or K2 ``rollout[_turbo][_bf16]``,
  ``models/solve.py:solve_rollout_mode``) with B = the robots that align
  this step; robots on their first scan and inactive robots are left out,
  and a step where none aligns launches nothing.  The plain cost modes run
  the solo ``align`` per aligning robot on its view (what the JAX ``vmap``
  of ``align`` computes).
* The map update writes the float32 per-cell fields through
  ``ops/row_scatter.py:row_scatter``, one call per id stream and width:
  ``{mean_c, g_sum, cur_sum}`` at W=2 and ``{inv_cov, g_cov, cur_m2}`` at
  W=3 (a launch each on a CUDA device; duplicate ids compute identical
  rows, so the kernel's one-winner-whole rule gives the solo bits).  The
  integer and bool fields and the ring's slot writes use indexed
  assignment, and so does every field of a map whose dtype is not
  float32: the choice is made by dtype, never as a fallback.
* The XLA shapes of the JAX fleet (whole ring rows moved with a one-hot
  select of the open slot) are not ported: the open slot is written per
  element, as the solo ``build_touched`` does.
* Recovery is host-escalated, as in the JAX package: the step dead-reckons
  dropouts and quarantines lost robots' scans, and with recovery on reads
  the lost flags on the host once per step; :func:`relocalize_fleet_robot`
  runs the solo relocalization (``models/slam.py:_relocalize``, K3 in
  stages 2-3 on a CUDA device) on one robot's views.
* The occupancy raster is refused (:func:`_check_fleet_cfg`): raster
  fleets run ``models/slam.py:run_offline_batch`` or the session pool's
  per-session step.

Over ranks (``torch.distributed``, :func:`make_fleet_sharded`): each rank
runs :func:`run_offline_fleet` on its own robots.  Maps are private, so the
run needs no collective; the poses and costs gather in rank order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ndtpso_slam_tpu_torch.config import MapConfig, SlamConfig
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models import ndt_map
from ndtpso_slam_tpu_torch.models import solve as solve_mod
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot, NdtMapState
from ndtpso_slam_tpu_torch.models.pso import PsoResult
from ndtpso_slam_tpu_torch.models.scan import Scan
from ndtpso_slam_tpu_torch.models.slam import (
    AlignState,
    SlamState,
    _relocalize,
    align,
    session_state,
)
from ndtpso_slam_tpu_torch.models.solve import solve_rollout_mode
from ndtpso_slam_tpu_torch.ops import _build, rng
from ndtpso_slam_tpu_torch.ops.geometry import cell_index, transform_points
from ndtpso_slam_tpu_torch.ops.row_scatter import row_scatter
from ndtpso_slam_tpu_torch.parallel import runtime


def _mask(host: np.ndarray, device) -> torch.Tensor:
    """A host bool mask on ``device`` (a copy that does not wait for the
    stream)."""
    return torch.from_numpy(np.ascontiguousarray(host)).to(device, non_blocking=True)


# ndt_map.add_points for a stacked [B, ...] map, in place, as one flat update
# per field (wpts [B, N, 2], valid [B, N]).
fleet_add_points = ndt_map.add_points_stacked


def _put_rows(fields: List[torch.Tensor], idx: torch.Tensor, vals: List[torch.Tensor]) -> None:
    """``field[idx] = val`` for fields of one width on one id stream: one
    ``row_scatter`` call for float32 fields (the kernel on a CUDA device),
    indexed assignment for any other dtype."""
    if fields[0].dtype == torch.float32:
        row_scatter(fields, idx, vals)
    else:
        for f, v in zip(fields, vals):
            f[idx] = v


def fleet_build_touched(ms: NdtMapState, cfg: MapConfig, ids: torch.Tensor) -> NdtMapState:
    """``ndt_map.build_touched`` for a stacked [B, ...] map, in place
    (``ndt_map.build_touched_stacked``), its float per-cell fields written
    through :func:`_put_rows`.  ids: [B, M] robot-local cell ids (>= C
    dropped)."""
    return ndt_map.build_touched_stacked(ms, cfg, ids, _put_rows)


def _snapshots(ms: NdtMapState, cfg: MapConfig) -> MapSnapshot:
    """Every robot's snapshot, stacked [B, C, ...] (the solo
    ``ndt_map.snapshot`` per robot)."""
    c = cfg.num_cells
    centers = ndt_map.cell_centers(cfg, ms.mean_c.dtype, ms.mean_c.device)
    return MapSnapshot(mean=centers + ms.mean_c[:, :c], inv_cov=ms.inv_cov[:, :c],
                       built=ms.built[:, :c])


def _snap(snaps: MapSnapshot, i: int) -> MapSnapshot:
    return MapSnapshot(mean=snaps.mean[i], inv_cov=snaps.inv_cov[i], built=snaps.built[i])


def _align_rollout_fleet(
    keys,  # [B] (k0, k1) u32 words
    astates: AlignState,  # [B]-stacked, iter a host array
    snaps: MapSnapshot,  # [B, C, ...]
    scan_t: Scan,  # [B, N, ...]
    guesses: torch.Tensor,  # [B, 3]
    cfg: SlamConfig,
) -> Tuple[AlignState, PsoResult]:
    """``models/slam.py:align`` for B robots of a ``rollout*`` cost mode as
    ONE launch of the whole-solve kernel with B = robots: the adaptive
    deviation (``ndtframe.cpp:253``), the solve, and the exact-cost rescore
    of each winner (the solo rescore per robot, so the cost has the solo
    bits too)."""
    dtype, dev = guesses.dtype, guesses.device
    deviation = torch.abs(astates.pose_diff * cfg.deviation_scale)
    cold = np.nonzero(astates.iter < 2)[0].tolist()
    if cold:
        deviation[cold] = torch.tensor(cfg.first_deviation, dtype=dtype, device=dev)
    pose, _ = solve_rollout_mode(
        cfg.cost_mode, _build.u32_words(keys, dev), guesses, deviation, snaps,
        scan_t.points, scan_t.valid, cfg.map, cfg.pso, cfg.solver_early_exit,
    )
    pose = pose.to(dtype)
    exact = torch.stack([
        cost_mod.ndt_cost(pose[i][None], _snap(snaps, i), scan_t.points[i], scan_t.valid[i],
                          cfg.map)[0]
        for i in range(pose.shape[0])
    ])
    new = AlignState(prev_pose=pose, pose_diff=pose - astates.prev_pose, iter=astates.iter + 1)
    return new, PsoResult(pose=pose, cost=exact)


def _fleet_step(
    states: SlamState, scan_t: Scan, keys, cfg: SlamConfig, active: Optional[np.ndarray] = None,
) -> Tuple[SlamState, torch.Tensor, torch.Tensor, np.ndarray]:
    """One fleet step, in place: the solves of the aligning robots, then one
    flat map update.  ``slam_step``'s align/first-scan/fitness bookkeeping,
    with recovery's in-step part (dropout dead-reckoning, quarantine of lost
    robots) and without the raster.

    keys: B (k0, k1) u32 words; active: [B] host bool (None: all).  An
    inactive session keeps its state and writes no map row (its ids go to
    its spare row).  Returns (states, pose [B, 3], cost [B], lost [B] host
    bool, all False with recovery off)."""
    b = states.pose.shape[0]
    dtype, dev = states.pose.dtype, states.pose.device
    active = np.ones(b, bool) if active is None else np.asarray(active, bool)
    first = states.step == 0
    rows = np.nonzero(active & ~first)[0]
    old_pose, old_diff, old_fit = states.pose, states.align.pose_diff, states.fitness
    pose, prev_pose, pose_diff = old_pose.clone(), states.align.prev_pose.clone(), old_diff.clone()
    iters = states.align.iter.copy()
    cost = torch.zeros(b, dtype=dtype, device=dev)
    snaps = _snapshots(states.map, cfg.map)
    if rows.size and solve_mod.MODES[cfg.cost_mode].solve == "kernel":
        every = rows.size == b
        sub = (lambda t: t) if every else (lambda t: t[torch.from_numpy(rows).to(dev)])
        new, res = _align_rollout_fleet(
            [keys[i] for i in rows],
            AlignState(prev_pose=sub(prev_pose), pose_diff=sub(pose_diff), iter=iters[rows]),
            MapSnapshot(sub(snaps.mean), sub(snaps.inv_cov), sub(snaps.built)),
            Scan(points=sub(scan_t.points), valid=sub(scan_t.valid)), sub(pose), cfg)
        if every:
            pose, cost = res.pose, res.cost.to(dtype)
            prev_pose, pose_diff = new.prev_pose, new.pose_diff
        else:
            pose[rows], cost[rows] = res.pose, res.cost.to(dtype)
            prev_pose[rows], pose_diff[rows] = new.prev_pose, new.pose_diff
        iters[rows] = new.iter
    else:
        for i in rows:
            new, res = align(keys[i], AlignState(prev_pose=prev_pose[i], pose_diff=pose_diff[i],
                                                 iter=int(iters[i])),
                             _snap(snaps, i), Scan(points=scan_t.points[i], valid=scan_t.valid[i]),
                             old_pose[i], cfg)
            pose[i], cost[i] = res.pose, res.cost.to(dtype)
            prev_pose[i], pose_diff[i], iters[i] = new.prev_pose, new.pose_diff, new.iter
    for i in np.nonzero(active & first)[0]:
        # A first scan is not aligned: its cost is the exact cost at the
        # prior pose, as in the solo step.
        cost[i] = cost_mod.ndt_cost(old_pose[i][None], _snap(snaps, i), scan_t.points[i],
                                    scan_t.valid[i], cfg.map)[0].to(dtype)
    act = _mask(active, dev)
    n_valid = torch.sum(scan_t.valid, dim=1)
    fitness = torch.where(act, -cost / torch.clamp(n_valid, min=1).to(dtype), old_fit)

    consumed = active
    ingest_rows = active
    lost = np.zeros(b, bool)
    if cfg.recovery.enabled:
        # The maskable part of the solo step's recovery, for every robot at
        # once (JAX fleet.py:360-394); the relocalization sweep is escalated
        # per lost robot by the caller (relocalize_fleet_robot).
        rc = cfg.recovery
        stepped = act & _mask(~first, dev)
        deg_t = stepped & (n_valid < rc.min_valid_beams)
        lost_t = (stepped & ~deg_t & _mask(states.align.iter >= 2, dev)
                  & (fitness < rc.fitness_threshold))
        degraded, lost = torch.stack([deg_t, lost_t]).cpu().numpy()  # the step's one host read
        deg = _mask(degraded, dev)[:, None]
        pose = torch.where(deg, old_pose + old_diff, pose)
        # Dead-reckoned robots keep the previous velocity; lost robots keep
        # the failed align's bookkeeping (the escalation rewrites it).
        prev_pose = torch.where(_mask(first | ~active, dev)[:, None], prev_pose, pose)
        pose_diff = torch.where(deg, old_diff, pose_diff)
        # A dropout must not look lost to the escalation: keep its fitness.
        fitness = torch.where(deg[:, 0], old_fit, fitness)
        ingest_rows = active & ~degraded & ~lost  # quarantine map ingestion

    wpts = transform_points(scan_t.points, pose)
    idx, inb = cell_index(
        wpts, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
        cells_per_side=cfg.map.cells_per_side,
    )
    c = cfg.map.num_cells
    ingest = scan_t.valid & _mask(ingest_rows, dev)[:, None]
    ids = torch.where(ingest & inb, idx, c).to(torch.int32)
    # The previous scan's cells are rebuilt for every robot that consumed a
    # scan, quarantined or not (stale-slot eviction), as in the solo step.
    used = _mask(consumed, dev)[:, None]
    prev = torch.where(used, states.prev_ids, c)
    fleet_add_points(states.map, cfg.map, wpts, ingest)
    fleet_build_touched(states.map, cfg.map, torch.cat([ids, prev], dim=1))
    states.pose, states.fitness = pose, fitness
    states.align = AlignState(prev_pose=prev_pose, pose_diff=pose_diff, iter=iters)
    states.step = states.step + consumed
    states.prev_ids = torch.where(used, ids, states.prev_ids)
    return states, pose, torch.where(act, cost, 0.0), lost


def _step_keys(base_keys: np.ndarray, counters) -> list:
    """Per-robot step keys threefry2x32(base_key_b, counter_b, 0), on the host."""
    return [rng.derive_key(k, int(n)) for k, n in zip(base_keys, counters)]


def fleet_pool_step(
    states: SlamState, scans: Scan, base_keys, active, cfg: SlamConfig,
) -> Tuple[SlamState, torch.Tensor, torch.Tensor, np.ndarray]:
    """The session pool's step through the flat fleet: robot b's key is
    threefry2x32(base_key_b, step_b, 0) from its own step counter.  Same
    contract as ``parallel/sessions.py:pool_step`` plus the lost flags [B]
    (host bool; all False with recovery off).  With recovery on the caller
    escalates each lost robot to :func:`relocalize_fleet_robot`."""
    _check_fleet_cfg(cfg, allow_recovery=True)
    keys = _step_keys(np.asarray(base_keys, np.int64).reshape(-1, 2), states.step)
    return _fleet_step(states, scans, keys, cfg, np.asarray(active, bool))


def relocalize_fleet_robot(
    states: SlamState, idx: int, scan: Scan, key, cfg: SlamConfig,
) -> Tuple[SlamState, torch.Tensor, torch.Tensor, bool]:
    """Host-escalated relocalization of ONE lost robot of a fleet, in place.

    The solo three-stage relocalization (``models/slam.py:_relocalize``) on
    robot ``idx``'s views, around its current pose, which is passed as both
    the last trusted pose and the failed one (as the JAX package does, its
    fault R3).  The pose is adopted only if it beats the failed align's
    exact cost (rebuilt from the stored fitness) with a fitness in
    [``accept_fitness``, 1], the solo step's accept bar; then the
    quarantined scan is ingested at the corrected pose by a flat update
    masked to this robot, and ``pose_diff`` resets (a jump is not motion).
    On reject nothing is ingested and the pose stays.  The other robots'
    rows are not written.  One host read: the accept decision.

    scan: the scan the step quarantined ([N, ...]); key: (k0, k1), the
    step's key.  Returns (states, pose [3], cost [], accepted)."""
    b = states.pose.shape[0]
    dtype, dev = states.pose.dtype, states.pose.device
    view = session_state(states, idx)
    last_pose = view.pose.clone()
    rpose, rcost = _relocalize(key, ndt_map.snapshot(view.map, cfg.map), scan, last_pose,
                               last_pose, cfg)
    nv = torch.clamp(torch.sum(scan.valid), min=1).to(dtype)
    cur_cost = -states.fitness[idx] * nv
    rfit = -rcost / nv
    accept = bool((rcost < cur_cost) & (rfit >= cfg.recovery.accept_fitness) & (rfit <= 1.0))
    pose, cost = (rpose, rcost) if accept else (last_pose, cur_cost)
    if accept:
        c = cfg.map.num_cells
        wpts = transform_points(scan.points, pose)
        cidx, inb = cell_index(wpts, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
                               cells_per_side=cfg.map.cells_per_side)
        ids = torch.where(scan.valid & inb, cidx, c).to(torch.int32)
        rowmask = (torch.arange(b, device=dev) == idx)[:, None]
        fleet_add_points(states.map, cfg.map, wpts[None].expand(b, -1, -1),
                         scan.valid[None] & rowmask)
        fleet_build_touched(states.map, cfg.map, torch.where(rowmask, ids[None], c))
        states.align.pose_diff[idx] = 0.0
        states.fitness[idx] = -cost / nv
        states.recoveries[idx] += 1
        states.prev_ids[idx] = ids
    states.align.prev_pose[idx] = pose
    states.pose[idx] = pose
    return states, pose, cost, accept


def _check_fleet_cfg(cfg: SlamConfig, allow_recovery: bool = False) -> None:
    """Raise ValueError for what the flat fleet does not run (JAX
    ``fleet.py:_check_fleet_cfg``): recovery in an offline runner, the
    occupancy raster, GLIR with a rollout mode (and any configuration the
    solo step refuses)."""
    if cfg.recovery.enabled and not allow_recovery:
        raise ValueError(
            "offline flat-fleet runners cannot escalate a lost robot mid-run; use "
            "SlamSessionPool / fleet_pool_step + relocalize_fleet_robot for "
            "recovery-enabled fleets, or run_offline_batch"
        )
    if cfg.og.enabled:
        raise ValueError(
            "the flat-fleet path does not raster occupancy grids; use run_offline_batch "
            "(or raster per robot offline from the map state export)"
        )
    solve_mod.check(cfg.cost_mode, cfg.optimizer, node=True)


def run_offline_fleet(
    states: SlamState, scans: Scan, base_keys, cfg: SlamConfig
) -> Tuple[SlamState, torch.Tensor, torch.Tensor]:
    """B SLAM sessions over recorded logs through the flat fleet.  Same
    contract as ``models/slam.py:run_offline_batch`` (states from
    ``init_slam_batch``, updated in place; scans [B, T, ...]; base_keys
    [B, 2]; scan t of robot b uses key threefry2x32(base_key_b, t, 0), as
    ``run_offline`` does) and the same per-robot results.  Returns (states,
    poses [B, T, 3], costs [B, T])."""
    _check_fleet_cfg(cfg)
    keys = np.asarray(base_keys, np.int64).reshape(-1, 2)
    poses, costs = [], []
    for t in range(scans.points.shape[1]):
        states, pose, cost, _ = _fleet_step(
            states, Scan(points=scans.points[:, t], valid=scans.valid[:, t]),
            _step_keys(keys, [t] * keys.shape[0]), cfg)
        poses.append(pose)
        costs.append(cost)
    return states, torch.stack(poses, dim=1), torch.stack(costs, dim=1)


def make_fleet_sharded(mesh, cfg: SlamConfig, axis=None):
    """The fleet with its robots sharded over the ranks along ``axis``
    (default: every axis of the mesh): a
    runner ``(states, scans, base_keys) -> (states, poses, costs)`` over
    this rank's robots (states from ``init_slam_batch`` of its robots, scans
    [B/D, T, ...], keys [B/D, 2]), each rank's :func:`run_offline_fleet`.
    The configuration is checked once, here; ``axis`` is only validated:
    the caller cuts its robots with ``runtime.shard_rows``."""
    _check_fleet_cfg(cfg)
    mesh.axis_names(mesh.axes if axis is None else axis)
    return lambda states, scans, base_keys: run_offline_fleet(states, scans, base_keys, cfg)


def run_offline_fleet_sharded(mesh, states: SlamState, scans: Scan, base_keys, cfg: SlamConfig,
                              axis=None) -> Tuple[SlamState, torch.Tensor, torch.Tensor]:
    """One sharded fleet run: this rank's robots in, (its states, the whole
    fleet's poses [B, T, 3] and costs [B, T] in rank order) out on every
    rank.  The maps stay on their ranks."""
    states, poses, costs = make_fleet_sharded(mesh, cfg, axis)(states, scans, base_keys)
    poses, costs = runtime.gather_global(mesh, (poses, costs), axis)
    return states, poses, costs
