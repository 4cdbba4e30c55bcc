"""The scan-synchronous SLAM pipeline: align -> (recover) -> update -> build.

Port of ``ndtpso_slam_tpu/models/slam.py`` (``NDTPSONode::scan_matcher_``,
``ndtpso_slam_node.cpp:177-244``, and ``NDTFrame::align``,
``ndtframe.cpp:251-266``):

* the adaptive particle deviation, twice the last inter-scan motion after
  the two cold-start scans (``ndtframe.cpp:253``);
* the first scan: no align, pose := previous pose
  (``ndtpso_slam_node.cpp:188-195``);
* the map update with the aligned pose, then an explicit build of the cells
  this scan and the previous one touched;
* with ``cfg.og.enabled``, the occupancy raster refreshed from the cells this
  scan touched (``models/occupancy.py:og_update_incremental``);
* with ``cfg.recovery.enabled``, tracking-loss recovery: a scan with too few
  valid beams dead-reckons and is not ingested; a poor match fitness after
  the cold start triggers the three-stage relocalization (:func:`_relocalize`)
  around the last trusted pose, whose pose is accepted only if it beats the
  failed align and its fitness is sane.

Differences from the JAX package, none of which changes a result:

* PyTorch runs eagerly, so the step counter ``SlamState.step`` and the align
  counter ``AlignState.iter`` are Python ints on the host: the first-scan and
  cold-start tests are host branches, not device selects.
* On the first scan the JAX step computes an align and throws it away; the
  port skips it.  Its cost is the exact cost at the prior pose, which on the
  empty first map is the 0 the discarded align reports there.  So a run of T
  scans launches the rollout kernel T - 1 times.
* The map is updated in place (see ``models/ndt_map.py``).
* The recovery branch is a host branch: with recovery on, the step reads the
  0-d tracking-loss flag on the host (one synchronization), and on that
  branch the accept decision; with recovery off it adds none.  The number of
  accepted relocalizations, ``SlamState.recoveries``, is a Python int.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ndtpso_slam_tpu_torch.config import RECOVERY_AUTO_STRIDE_MIN_CELLS, SlamConfig, resolve_device
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models import ndt_map, occupancy
from ndtpso_slam_tpu_torch.models.pso import OPTIMIZERS, PsoResult, _select_min, pso_solve_batch
from ndtpso_slam_tpu_torch.models.scan import Scan
from ndtpso_slam_tpu_torch.ops import rng
from ndtpso_slam_tpu_torch.ops.geometry import cell_index, transform_points
from ndtpso_slam_tpu_torch.ops.rollout import solve_rollout_mode


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
    og: Optional[occupancy.OccupancyGrid]  # None unless cfg.og.enabled
    pose: torch.Tensor  # [3] current estimate
    step: int
    fitness: torch.Tensor  # [] mean exact NDT score per valid beam
    recoveries: int  # accepted relocalizations, cumulative
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
        og=occupancy.init_og(cfg.map, cfg.og, dev) if cfg.og.enabled else None,
        pose=pose,
        step=0,
        fitness=torch.zeros((), dtype=dtype, device=dev),
        recoveries=0,
        prev_ids=torch.full(
            (cfg.scan.max_beams,), cfg.map.num_cells, dtype=torch.int32, device=dev
        ),
    )


# The JAX package's cost modes (models/slam.py:SLAM_COST_MODES).
SLAM_COST_MODES = (
    "exact", "fast", "fast_local", "local_exact",
    "rollout", "rollout_bf16", "rollout_turbo", "rollout_turbo_bf16",
    "rollout_local", "rollout_local_turbo",
)


def validate_config(cfg: SlamConfig) -> None:
    """Raise ValueError for a configuration the JAX package refuses: an
    unknown cost mode or optimizer, or GLIR with a ``rollout*`` mode (the
    whole-solve kernels run the deployed PSO update rule only; the JAX
    package raises this in ``align``, ``slam.py:199-204``)."""
    if cfg.cost_mode not in SLAM_COST_MODES:
        raise ValueError(
            f"unknown cost_mode {cfg.cost_mode!r}; expected one of {SLAM_COST_MODES}"
        )
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; expected 'pso' | 'glir'")
    if cfg.cost_mode.startswith("rollout") and cfg.optimizer != "pso":
        raise ValueError(
            "rollout cost modes implement the deployed PSO update rule "
            f"only; optimizer={cfg.optimizer!r} needs a plain cost mode"
        )


def make_cost_fn(snap: ndt_map.MapSnapshot, scan: Scan, cfg: SlamConfig, guess=None):
    """Batched cost closure for the solver, per the configured cost mode
    (the modes that do not run a whole-solve kernel)."""
    if cfg.cost_mode == "exact":
        return lambda poses, bind: cost_mod.ndt_cost(
            poses, snap, scan.points, scan.valid, cfg.map
        )
    if cfg.cost_mode == "fast":
        return lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points(bind, snap, scan.points, scan.valid, cfg.map)
        )
    if cfg.cost_mode == "fast_local":
        # The stencil gathered once at the guess; the incumbent rebinds
        # within it every iteration.
        nbr = cost_mod.bind_neighborhood(
            guess, snap, scan.points, scan.valid, cfg.map,
            radius=cost_mod.DEFAULT_STENCIL_RADIUS,
        )
        return lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points_local(bind, nbr, scan.points, cfg.map)
        )
    if cfg.cost_mode == "local_exact":
        nbr = cost_mod.bind_neighborhood(
            guess, snap, scan.points, scan.valid, cfg.map,
            radius=cost_mod.DEFAULT_STENCIL_RADIUS,
        )
        return lambda poses, bind: cost_mod.stencil_exact_cost(
            poses, nbr, scan.points, cfg.map
        )
    raise ValueError(f"cost_mode {cfg.cost_mode!r} runs a whole-solve kernel, not a cost "
                     "function (align dispatches it to _align_rollout)")


def _align_rollout(key, guess, deviation, snap, scan, cfg: SlamConfig) -> PsoResult:
    """One B = 1 solve through the whole-solve kernel of a ``rollout*``
    cost mode (``ops/rollout.py:solve_rollout_mode``)."""
    # The key's u32 words as the kernel takes them, int32 bit patterns, made
    # on the host: one host-to-device copy that does not wait for the
    # stream, and no conversion on the device.
    keys = (torch.tensor([[key[0], key[1]]], dtype=torch.int64) & 0xFFFFFFFF).to(torch.int32)
    keys = keys.to(guess.device, non_blocking=True)
    pose, c = solve_rollout_mode(
        cfg.cost_mode, keys, guess[None], deviation[None], snap, scan.points[None],
        scan.valid[None], cfg.map, cfg.pso, cfg.solver_early_exit,
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
    """``NDTFrame::align`` (``ndtframe.cpp:251-266``): adaptive deviation +
    the configured optimizer (PSO, or GLIR-PSO on the plain cost modes),
    then the winning pose re-scored with the exact cost."""
    validate_config(cfg)
    dtype = guess.dtype
    if astate.iter < 2:
        deviation = torch.tensor(cfg.first_deviation, dtype=dtype, device=guess.device)
    else:
        deviation = torch.abs(astate.pose_diff * cfg.deviation_scale)
    if cfg.cost_mode.startswith("rollout"):
        result = _align_rollout(key, guess, deviation, snap, scan, cfg)
    else:
        result = OPTIMIZERS[cfg.optimizer](
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


def _linspace(s: float, n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(-s, s, n, dtype)`` as XLA-CPU computes it with constant
    arguments: t = i / (n - 1) becomes i·r with r = 1/(n - 1), and the end
    term is reassociated, so entry i < n - 1 is ``start·(1 - i·r) + i·(stop·r)``
    (float32, no fused multiply-add) and the last is ``stop``.  These bits
    equal XLA's constant-folded ``jnp.linspace``; a compiled one with runtime
    arguments may contract some products into fmas and differ by an ulp
    (ROADMAP §3)."""
    f = lambda v: torch.tensor(v, dtype=dtype)
    start, stop = f(-s), f(s)
    if n == 1:
        return start[None].to(device)
    r = f(1.0) / f(n - 1)
    i = torch.arange(n - 1, dtype=dtype)
    out = start * (1.0 - i * r) + i * (stop * r)
    return torch.cat([out, stop[None]]).to(device)


def _reloc_grid(last_pose: torch.Tensor, rc, dtype) -> torch.Tensor:
    """Dense pose grid over ±spread around the last trusted pose, [G, 3]
    (x slowest, θ fastest)."""
    (nx, ny, nt), (sx, sy, st) = rc.grid, rc.spread
    dev = last_pose.device
    gx, gy, gt = torch.meshgrid(_linspace(sx, nx, dtype, dev), _linspace(sy, ny, dtype, dev),
                                _linspace(st, nt, dtype, dev), indexing="ij")
    return last_pose + torch.stack([gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)], dim=-1)


def _nms_top_k(grid: torch.Tensor, costs: torch.Tensor, k: int, radius: torch.Tensor):
    """Greedy non-max-suppressed top-K over the pose grid: K picks, each the
    first minimum of the costs left, after which every grid pose within
    ±radius of it (θ wrapped) is suppressed.  Returns [K, 3] poses, best
    first."""
    two_pi = torch.tensor(2.0 * math.pi, dtype=grid.dtype).to(grid.device)
    inf = torch.full((), float("inf"), dtype=costs.dtype, device=costs.device)
    hyps = []
    for _ in range(k):
        _, bp = _select_min(costs, grid)
        d = torch.abs(grid - bp)
        dth = torch.minimum(d[:, 2], two_pi - d[:, 2])
        near = (d[:, 0] <= radius[0]) & (d[:, 1] <= radius[1]) & (dth <= radius[2])
        costs = torch.where(near, inf, costs)
        hyps.append(bp)
    return torch.stack(hyps)


# Stage 1 scores the grid this many poses at a time, bounding its [chunk, N]
# intermediates (~60 bytes per pose and beam).
RELOC_CHUNK = 4096


def _relocalize(key, snap: ndt_map.MapSnapshot, scan: Scan, last_pose: torch.Tensor,
                failed_pose: torch.Tensor, cfg: SlamConfig):
    """Three-stage relocalization around the last trusted pose (JAX
    ``models/slam.py:_relocalize``).

    1. The exact cost of every pose of the ``rc.grid`` grid against a
       snapshot inflated by ``grid_sigma`` (coarse-to-fine NDT), on every
       ``stride``-th beam; non-max suppression turns the scores into K
       distinct hypotheses, rows 0 and 1 replaced by the last pose and the
       failed align's.
    2. The K hypotheses refined as one batch of K independent swarms
       (``rc.pso``, ``rc.deviation``) on the frozen cost rebound at each
       swarm's incumbent every iteration, against a snapshot inflated by
       ``refine_sigma``.
    3. Each refined pose polished the same way on the un-inflated map, then
       the winner picked by the exact cost (first minimum).

    The binder reads a ``patch_cells`` window around the last pose where the
    window is smaller than the grid (``cost.bind_points_matmul_window``).  On
    a CUDA device stages 2-3 score through the fused scoring kernel
    (``cost.bound_cost_fused``); on the CPU through ``cost.bound_cost``.
    key: (k0, k1) u32 words.  Returns (pose [3], exact cost [])."""
    rc = cfg.recovery
    dtype, dev = last_pose.dtype, last_pose.device
    k = rc.k_hypotheses

    # Stage 1: the coarse grid and its hypotheses.
    grid = _reloc_grid(last_pose, rc, dtype)
    stride = int(rc.grid_beam_stride)
    if stride <= 0:
        stride = 2 if cfg.map.num_cells >= RECOVERY_AUTO_STRIDE_MIN_CELLS else 1
    coarse_snap = ndt_map.smooth_snapshot(snap, rc.grid_sigma)
    s_points, s_valid = scan.points[::stride], scan.valid[::stride]
    costs = torch.cat([
        cost_mod.ndt_cost(chunk, coarse_snap, s_points, s_valid, cfg.map)
        for chunk in grid.split(RELOC_CHUNK)
    ])
    (nx, ny, nt), (sx, sy, st) = rc.grid, rc.spread
    spacing = torch.tensor([2.0 * sx / max(nx - 1, 1), 2.0 * sy / max(ny - 1, 1),
                            2.0 * st / max(nt - 1, 1)], dtype=dtype).to(dev)
    hypo = _nms_top_k(grid, costs, k, 1.5 * spacing)
    hypo[0] = last_pose
    if k > 1:
        hypo[1] = failed_pose
    return _refine_hypotheses(key, snap, scan, last_pose, hypo, cfg)


def _refine_hypotheses(key, snap: ndt_map.MapSnapshot, scan: Scan, last_pose: torch.Tensor,
                       hypo: torch.Tensor, cfg: SlamConfig):
    """Stages 2-3 of :func:`_relocalize` on the hypotheses [K, 3]: refine,
    polish, then the exact-cost winner (pose [3], cost [])."""
    rc = cfg.recovery
    dtype, dev = last_pose.dtype, last_pose.device
    k = hypo.shape[0]
    # The window binder, rebound at each swarm's incumbent.
    w_cells = cfg.map.cells_per_side
    ps = rc.patch_cells if 0 < rc.patch_cells < w_cells else 0
    if ps:
        origin = cost_mod.window_origin(last_pose, ps, cfg.map)

        def make_cost(tbl):
            patch = cost_mod.table_window(tbl, origin, ps, cfg.map)
            return lambda poses, binds: cost_mod.bound_cost_fused(
                poses, cost_mod.bind_points_matmul_window(
                    binds, patch, origin, ps, scan.points, scan.valid, cfg.map))
    else:
        def make_cost(tbl):
            return lambda poses, binds: cost_mod.bound_cost_fused(
                poses, cost_mod.bind_points_matmul(binds, tbl, scan.points, scan.valid, cfg.map))

    rk = rng.threefry2x32(key, 0x5EC0, 0xFA11)
    ids = torch.arange(k, dtype=torch.int64)
    swarm_keys = lambda c0, c1: torch.stack(rng.threefry2x32(rk, c0, c1), dim=-1)
    refine_snap = ndt_map.smooth_snapshot(snap, rc.refine_sigma) if rc.refine_sigma > 0 else snap
    expand = lambda v: torch.tensor(v, dtype=dtype).to(dev).expand(k, 3)
    refined = pso_solve_batch(
        swarm_keys(ids, torch.full_like(ids, 0x5117)), hypo, expand(rc.deviation),
        make_cost(cost_mod.snapshot_table(refine_snap)), rc.pso,
    ).pose
    polished = pso_solve_batch(
        swarm_keys(ids + 0x907, torch.full_like(ids, 0x13)), refined, expand((0.1, 0.1, 0.05)),
        make_cost(cost_mod.snapshot_table(snap)), rc.pso,
    ).pose
    final = cost_mod.ndt_cost(polished, snap, scan.points, scan.valid, cfg.map)
    best_cost, best_pose = _select_min(final, polished)
    return best_pose.to(dtype), best_cost.to(dtype)


def slam_step(
    state: SlamState, scan: Scan, key, cfg: SlamConfig
) -> Tuple[SlamState, torch.Tensor, torch.Tensor]:
    """One scan-synchronous SLAM step.  key: (k0, k1) u32 words.
    Returns (state', pose [3], cost []).

    Host synchronizations: none with recovery off.  With recovery on, after
    the cold-start scans, one read of the 0-d tracking-loss flag, and when
    it is set one read of the accept decision."""
    validate_config(cfg)
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
    ingest_valid = scan.valid
    recoveries = state.recoveries

    if cfg.recovery.enabled and state.step > 0:
        rc = cfg.recovery
        # Sensor dropout: too few valid beams to match against.  Dead-reckon
        # at constant velocity and keep the scan out of the map.
        degraded = n_valid < rc.min_valid_beams
        dead_pose = state.pose + state.align.pose_diff
        # Tracking loss: the align ran its budget after the cold start, but
        # the exact score is poor.
        accepted = False
        if state.align.iter >= 2 and bool(~degraded & (fitness < rc.fitness_threshold)):
            rpose, rcost = _relocalize(key, snap, scan, state.pose, pose, cfg)
            # Accept only a pose strictly better than the failed align whose
            # fitness lies in [accept_fitness, 1] (NaN fails every test).
            rfit = -rcost / torch.clamp(n_valid, min=1).to(dtype)
            accepted = bool((rcost < cost) & (rfit >= rc.accept_fitness) & (rfit <= 1.0))
            if accepted:
                pose, cost = rpose, rcost
        pose = torch.where(degraded, dead_pose, pose)
        fitness = -cost / torch.clamp(n_valid, min=1).to(dtype)
        # A relocalization jump is not motion (pose_diff := 0); a
        # dead-reckoned step keeps the previous velocity estimate.
        kept = torch.zeros_like(pose) if accepted else astate.pose_diff
        astate = AlignState(prev_pose=pose,
                            pose_diff=torch.where(degraded, state.align.pose_diff, kept),
                            iter=astate.iter)
        ingest_valid = scan.valid & ~degraded
        recoveries += int(accepted)

    wpts = transform_points(scan.points, pose)
    idx, inb = cell_index(
        wpts, size_m=cfg.map.size_m, cell_side_m=cfg.map.cell_side_m,
        cells_per_side=cfg.map.cells_per_side,
    )
    ids = torch.where(ingest_valid & inb, idx, cfg.map.num_cells).to(torch.int32)
    new_map = ndt_map.add_points(state.map, cfg.map, wpts, ingest_valid)
    # A scan changes only the cells it binned into, plus last scan's cells
    # (post-rotation slot eviction): build exactly those.
    new_map = ndt_map.build_touched(new_map, cfg.map, torch.cat([ids, state.prev_ids]))
    og = state.og
    if og is not None:
        # Only this scan's cells, as the JAX step refreshes them: a cell
        # rebuilt for last scan's ids alone keeps its stale block (ROADMAP R1).
        og = occupancy.og_update_incremental(og, new_map, cfg.map, cfg.og, ids)
    new_state = SlamState(
        map=new_map, align=astate, og=og, pose=pose, step=state.step + 1,
        fitness=fitness, recoveries=recoveries, prev_ids=ids,
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
