"""The scan-synchronous SLAM pipeline: align -> update -> build.

Port of ``ndtpso_slam_tpu/models/slam.py`` with recovery off
(``NDTPSONode::scan_matcher_``, ``ndtpso_slam_node.cpp:177-244``, and
``NDTFrame::align``, ``ndtframe.cpp:251-266``):

* the adaptive particle deviation, twice the last inter-scan motion after
  the two cold-start scans (``ndtframe.cpp:253``);
* the first scan: no align, pose := previous pose
  (``ndtpso_slam_node.cpp:188-195``);
* the map update with the aligned pose, then an explicit build of the cells
  this scan and the previous one touched.

Differences from the JAX package, none of which changes a result:

* PyTorch runs eagerly, so the step counter ``SlamState.step`` and the align
  counter ``AlignState.iter`` are Python ints on the host: the first-scan and
  cold-start tests are host branches, not device selects.
* On the first scan the JAX step computes an align and throws it away; the
  port skips it.  Its cost is the exact cost at the prior pose, which on the
  empty first map is the 0 the discarded align reports there.  So a run of T
  scans launches the rollout kernel T - 1 times.
* The map is updated in place (see ``models/ndt_map.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ndtpso_slam_tpu_torch.config import SlamConfig, resolve_device
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models import ndt_map
from ndtpso_slam_tpu_torch.models.pso import PsoResult, pso_solve
from ndtpso_slam_tpu_torch.models.scan import Scan
from ndtpso_slam_tpu_torch.ops import rng
from ndtpso_slam_tpu_torch.ops.geometry import cell_index, transform_points
from ndtpso_slam_tpu_torch.ops.rollout_local import (
    pack_rollout_local_inputs,
    pso_rollout_local,
)


@dataclasses.dataclass
class AlignState:
    """Per-map alignment bookkeeping (``NDTFrame`` s_prev_pose, s_pose_diff,
    s_iter)."""

    prev_pose: torch.Tensor  # [3]
    pose_diff: torch.Tensor  # [3]
    iter: int


@dataclasses.dataclass
class SlamState:
    map: ndt_map.NdtMapState
    align: AlignState
    og: Optional[object]  # occupancy grid: not ported yet, always None
    pose: torch.Tensor  # [3] current estimate
    step: int
    fitness: torch.Tensor  # [] mean exact NDT score per valid beam
    recoveries: int  # accepted relocalizations: recovery is not ported, 0
    prev_ids: torch.Tensor  # [N] int32 cells touched by the previous scan


def init_slam(cfg: SlamConfig, initial_pose=(0.0, 0.0, 0.0), device="cuda") -> SlamState:
    """Fresh SLAM state with its map on ``device``."""
    dev = resolve_device(device)
    dtype = cfg.dtype
    pose = torch.as_tensor(initial_pose, dtype=dtype).to(dev)
    return SlamState(
        map=ndt_map.init_map(cfg.map, dtype, dev),
        align=AlignState(
            prev_pose=pose.clone(), pose_diff=torch.zeros(3, dtype=dtype, device=dev),
            iter=0,
        ),
        og=None,
        pose=pose,
        step=0,
        fitness=torch.zeros((), dtype=dtype, device=dev),
        recoveries=0,
        prev_ids=torch.full(
            (cfg.scan.max_beams,), cfg.map.num_cells, dtype=torch.int32, device=dev
        ),
    )


# Cost modes the port runs.  The JAX package's other modes (fast*, the
# frozen rollout* kernels, rollout_local_turbo) are listed in ROADMAP.
SLAM_COST_MODES = ("exact", "local_exact", "rollout_local")


def check_supported(cfg: SlamConfig) -> None:
    """Raise NotImplementedError for configuration the port cannot run yet."""
    if cfg.cost_mode not in SLAM_COST_MODES:
        raise NotImplementedError(
            f"cost_mode {cfg.cost_mode!r} is not ported yet (ROADMAP: fast*/rollout* "
            f"modes, K1 turbo); the port runs {SLAM_COST_MODES}"
        )
    if cfg.optimizer != "pso":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP B3)"
        )
    if cfg.recovery.enabled:
        raise NotImplementedError("tracking-loss recovery is not ported yet (ROADMAP B2)")
    if cfg.og.enabled:
        raise NotImplementedError("the occupancy grid is not ported yet (ROADMAP B1)")
    if cfg.map.ring_rows > 0:
        raise NotImplementedError("sparse ring_rows is not ported yet (ROADMAP A5)")


def make_cost_fn(snap: ndt_map.MapSnapshot, scan: Scan, cfg: SlamConfig, guess=None):
    """Batched cost closure for the solver (``exact`` and ``local_exact``)."""
    if cfg.cost_mode == "exact":
        return lambda poses, bind: cost_mod.ndt_cost(
            poses, snap, scan.points, scan.valid, cfg.map
        )
    if cfg.cost_mode == "local_exact":
        nbr = cost_mod.bind_neighborhood(
            guess, snap, scan.points, scan.valid, cfg.map,
            radius=cost_mod.DEFAULT_STENCIL_RADIUS,
        )
        return lambda poses, bind: cost_mod.stencil_exact_cost(
            poses, nbr, scan.points, cfg.map
        )
    raise NotImplementedError(f"no cost function for cost_mode {cfg.cost_mode!r}")


def _align_rollout(key, guess, deviation, snap, scan, cfg: SlamConfig) -> PsoResult:
    """One solve through the rollout kernel (``pso_rollout_local``)."""
    nbr = cost_mod.bind_neighborhood(
        guess, snap, scan.points, scan.valid, cfg.map,
        radius=cost_mod.DEFAULT_STENCIL_RADIUS,
    )
    sten, pts = pack_rollout_local_inputs(nbr, scan.points)
    keys = torch.tensor([[key[0], key[1]]], dtype=torch.int64).to(guess.device)
    pose, c = pso_rollout_local(
        keys, guess[None].to(torch.float32), deviation.to(torch.float32)[None],
        sten[None], pts[None], cfg.pso, cfg.map,
        radius=cost_mod.DEFAULT_STENCIL_RADIUS, early_exit=cfg.solver_early_exit,
    )
    return PsoResult(pose=pose[0].to(guess.dtype), cost=c[0])


def align(
    key,
    astate: AlignState,
    snap: ndt_map.MapSnapshot,
    scan: Scan,
    guess: torch.Tensor,
    cfg: SlamConfig,
) -> Tuple[AlignState, PsoResult]:
    """``NDTFrame::align`` (``ndtframe.cpp:251-266``): adaptive deviation + PSO,
    then the winning pose re-scored with the exact cost."""
    dtype = guess.dtype
    if astate.iter < 2:
        deviation = torch.tensor(cfg.first_deviation, dtype=dtype, device=guess.device)
    else:
        deviation = torch.abs(astate.pose_diff * cfg.deviation_scale)
    if cfg.cost_mode == "rollout_local":
        result = _align_rollout(key, guess, deviation, snap, scan, cfg)
    else:
        result = pso_solve(
            key, guess, deviation, make_cost_fn(snap, scan, cfg, guess), cfg.pso
        )
    if cfg.cost_mode != "exact":
        exact = cost_mod.ndt_cost(
            result.pose[None, :], snap, scan.points, scan.valid, cfg.map
        )[0]
        result = PsoResult(pose=result.pose, cost=exact)
    new_astate = AlignState(
        prev_pose=result.pose,
        pose_diff=result.pose - astate.prev_pose,
        iter=astate.iter + 1,
    )
    return new_astate, result


def slam_step(
    state: SlamState, scan: Scan, key, cfg: SlamConfig
) -> Tuple[SlamState, torch.Tensor, torch.Tensor]:
    """One scan-synchronous SLAM step.  key: (k0, k1) u32 words.
    Returns (state', pose [3], cost [])."""
    check_supported(cfg)
    dtype = state.pose.dtype
    snap = ndt_map.snapshot(state.map, cfg.map)
    if state.step == 0:
        astate, pose = state.align, state.pose
        cost = cost_mod.ndt_cost(pose[None, :], snap, scan.points, scan.valid, cfg.map)[0]
    else:
        astate, result = align(key, state.align, snap, scan, state.pose, cfg)
        pose, cost = result.pose, result.cost.to(dtype)
    n_valid = torch.sum(scan.valid)
    fitness = -cost / torch.clamp(n_valid, min=1).to(dtype)

    wpts = transform_points(scan.points, pose)
    idx, inb = cell_index(
        wpts, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
        cells_per_side=cfg.map.cells_per_side,
    )
    ids = torch.where(scan.valid & inb, idx, cfg.map.num_cells).to(torch.int32)
    new_map = ndt_map.add_points(state.map, cfg.map, wpts, scan.valid)
    # A scan changes only the cells it binned into, plus last scan's cells
    # (post-rotation slot eviction): build exactly those.
    new_map = ndt_map.build_touched(new_map, cfg.map, torch.cat([ids, state.prev_ids]))
    new_state = SlamState(
        map=new_map, align=astate, og=None, pose=pose, step=state.step + 1,
        fitness=fitness, recoveries=state.recoveries, prev_ids=ids,
    )
    return new_state, pose, cost


def run_offline(
    state: SlamState, scans: Scan, base_key, cfg: SlamConfig
) -> Tuple[SlamState, torch.Tensor, torch.Tensor]:
    """SLAM over a recorded scan log: scans has a leading time axis [T, ...];
    scan i uses key ``threefry2x32(base_key, i, 0)``.
    Returns (final_state, poses [T, 3], costs [T])."""
    poses, costs = [], []
    for i in range(scans.points.shape[0]):
        key = rng.derive_key(base_key, i)
        state, pose, c = slam_step(
            state, Scan(points=scans.points[i], valid=scans.valid[i]), key, cfg
        )
        poses.append(pose)
        costs.append(c)
    return state, torch.stack(poses), torch.stack(costs)
