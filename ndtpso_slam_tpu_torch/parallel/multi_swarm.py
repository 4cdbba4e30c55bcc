"""Multi-swarm PSO: K swarms against one shared map, one merged best.

Port of ``ndtpso_slam_tpu/parallel/multi_swarm.py`` on one GPU:

* :func:`multi_swarm_solve` runs K swarms as one ``pso_solve_batch`` call
  (the same per-swarm Threefry streams, init and update) whose islands
  exchange their global bests every ``exchange_every`` iterations: each swarm
  adopts the best incumbent of all K, its personal bests stay local.  Each
  swarm binds a frozen-correspondence cost at its own incumbent, so the cost
  callback is batched: ``(poses [K, P, 3], binds [K, 3]) -> [K, P]``.
* :func:`multi_swarm_rollout` runs the K swarms as one B = K launch of the
  whole-solve rollout kernel (``ops/rollout.py``, K2) with no exchange, then
  rescores the K winners with the exact cost and keeps the first minimum:
  the per-swarm rollout costs are bound at different hypotheses and are not
  comparable.

The cross-device exchange (``axis_name``, ``dcn_axis_name``,
``dcn_exchange_every``) is not ported yet and raises (ROADMAP E1).
"""

from __future__ import annotations

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.models.pso import RNG_MODES, PsoResult, _select_min, pso_solve_batch
from ndtpso_slam_tpu_torch.ops.rollout import SCORE_DTYPES, solve_rollout_mode


def _no_mesh(*axes) -> None:
    if any(a is not None for a in axes):
        raise NotImplementedError(
            "the multi-swarm exchange across devices is not ported yet (ROADMAP E1)"
        )


def _global_merge(gbest: torch.Tensor, gbest_cost: torch.Tensor, axis_name=None):
    """The best (pose [3], cost []) over the swarm axis [K]: the first
    minimum."""
    _no_mesh(axis_name)
    best_cost, best_pose = _select_min(gbest_cost, gbest)
    return best_pose, best_cost


def multi_swarm_solve(
    keys: torch.Tensor,  # [K, 2] integer u32 words, one key per swarm
    guesses: torch.Tensor,  # [K, 3] per-swarm hypotheses
    deviation,  # [3] shared search radius
    cost_fn,  # (poses [K, P, 3], binds [K, 3]) -> [K, P]
    cfg: PSOConfig,
    exchange_every: int = 1,
    axis_name=None,
    dcn_axis_name=None,
    dcn_exchange_every=None,
) -> PsoResult:
    """K-swarm PSO against one shared cost; returns the single best (pose
    [3], cost []) in the caller's dtype.  ``exchange_every=1`` makes every
    swarm chase one best; ``exchange_every >= cfg.iterations`` leaves them
    independent until the final merge."""
    _no_mesh(axis_name, dcn_axis_name, dcn_exchange_every)
    k = guesses.shape[0]
    devs = torch.as_tensor(deviation, dtype=guesses.dtype).to(guesses.device).expand(k, 3)
    res = pso_solve_batch(keys, guesses, devs, cost_fn, cfg, exchange_every=exchange_every)
    pose, cost = _global_merge(res.pose, res.cost)
    return PsoResult(pose=pose, cost=cost)


def multi_swarm_rollout(
    keys: torch.Tensor,  # [K, 2] integer u32 words, one key per swarm
    guesses: torch.Tensor,  # [K, 3] per-swarm hypotheses
    deviation,  # [3] shared search radius
    snap: MapSnapshot,  # the shared map
    points: torch.Tensor,  # [N, 2] query scan
    valid: torch.Tensor,  # [N] bool
    cfg: PSOConfig,
    map_cfg: MapConfig,
    axis_name=None,
    score_dtype: str = "f32",
    rng_mode: str = "threefry",
    early_exit: int = 0,
) -> PsoResult:
    """Island-model multi-swarm through the rollout kernel: the K swarms as
    one B = K solve, each stencil gathered at its own hypothesis against the
    one shared snapshot, then the exact-cost merge.  ``score_dtype`` "bf16"
    and ``rng_mode`` "native" take the ``rollout_bf16`` / ``rollout_turbo``
    kernel modes.  Returns the single best (pose [3], exact cost []) in the
    caller's dtype."""
    _no_mesh(axis_name)
    if score_dtype not in SCORE_DTYPES or rng_mode not in RNG_MODES:
        raise ValueError(f"unknown score_dtype {score_dtype!r} or rng_mode {rng_mode!r}")
    k = guesses.shape[0]
    mode = "rollout" + ("_turbo" if rng_mode == "native" else "") + (
        "_bf16" if score_dtype == "bf16" else "")
    g = guesses.to(torch.float32)
    devs = torch.as_tensor(deviation, dtype=torch.float32).to(g.device).expand(k, 3)
    poses, _ = solve_rollout_mode(mode, keys, g, devs, snap, points.expand(k, -1, -1),
                                  valid.expand(k, -1), map_cfg, cfg, early_exit)
    exact = cost_mod.ndt_cost(poses, snap, points, valid, map_cfg)  # [K]
    best_cost, best_pose = _select_min(exact, poses)
    return PsoResult(pose=best_pose.to(guesses.dtype), cost=best_cost.to(guesses.dtype))
