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

Across ranks (``torch.distributed``, ``parallel/runtime.py``) each rank
runs its own swarms, and ``axis_name`` (one mesh axis or a tuple) names the
ranks a merge covers, with ``mesh`` the rank's :class:`~runtime.Mesh`.  A
merge is the first minimum over the rank's swarms, an all-gather of that
(cost, pose) over the ranks along the axes, and the first minimum again, in
the order ``jax.lax.all_gather`` gives a tuple of axes (the first named
outermost; ``Mesh.members``).  With ``dcn_axis_name``, the merge every
``exchange_every`` iterations covers ``axis_name`` only (a host's devices)
and every ``dcn_exchange_every`` iterations it covers ``axis_name`` +
``dcn_axis_name`` (all hosts), that turn taking the place of the other; the
final merge covers every axis.
"""

from __future__ import annotations

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.models.pso import PsoResult, _select_min, pso_solve_batch
from ndtpso_slam_tpu_torch.models.solve import MODES, solve_rollout_mode
from ndtpso_slam_tpu_torch.parallel import runtime


def _axes(axis_name) -> tuple:
    if axis_name is None:
        return ()
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _global_merge(gbest: torch.Tensor, gbest_cost: torch.Tensor, mesh=None, axes=()):
    """The best (pose [3], cost []) over the swarm axis [K] and the ranks
    along ``axes``: the first minimum of this rank's, then of the gathered
    ones."""
    best_cost, best_pose = _select_min(gbest_cost, gbest)
    if axes:
        if mesh is None:
            raise ValueError(f"merging over the axes {axes} needs the rank's mesh")
        rows = runtime.all_gather(mesh, torch.cat([best_cost[None], best_pose]), axes)  # [D, 4]
        best_cost, best_pose = _select_min(rows[:, 0], rows[:, 1:])
    return best_pose, best_cost


def island_exchange(exchange_every=1, axis_name=None, dcn_axis_name=None,
                    dcn_exchange_every=None, mesh=None):
    """``pso_solve_batch``'s exchange for K islands: after iteration i, when
    (i + 1) % ``dcn_exchange_every`` == 0 (with ``dcn_axis_name``) the first
    minimum over the swarms and the ranks along ``axis_name`` +
    ``dcn_axis_name``, else when (i + 1) % ``exchange_every`` == 0 over the
    swarms and the ranks along ``axis_name``.  Returns (the exchange, the
    axes of the final merge)."""
    ici = _axes(axis_name)
    every = ici + _axes(dcn_axis_name)
    dcn_every = (dcn_exchange_every or exchange_every) if dcn_axis_name is not None else None

    def exchange(i, gbest, gbest_cost):
        if dcn_every is not None and (i + 1) % dcn_every == 0:
            return _global_merge(gbest, gbest_cost, mesh, every)
        if exchange_every > 0 and (i + 1) % exchange_every == 0:
            return _global_merge(gbest, gbest_cost, mesh, ici)
        return None

    return exchange, every


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
    mesh=None,
) -> PsoResult:
    """K-swarm PSO against one shared cost; returns the single best (pose
    [3], cost []) in the caller's dtype, the same on every rank.
    ``exchange_every=1`` makes every swarm chase one best; ``exchange_every
    >= cfg.iterations`` leaves them independent until the final merge.
    ``axis_name`` / ``dcn_axis_name`` merge across the ranks of ``mesh``
    (module docstring)."""
    exchange, every = island_exchange(exchange_every, axis_name, dcn_axis_name,
                                      dcn_exchange_every, mesh)
    k = guesses.shape[0]
    devs = torch.as_tensor(deviation, dtype=guesses.dtype).to(guesses.device).expand(k, 3)
    res = pso_solve_batch(keys, guesses, devs, cost_fn, cfg, exchange=exchange)
    pose, cost = _global_merge(res.pose, res.cost, mesh, every)
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
    mesh=None,
) -> PsoResult:
    """Island-model multi-swarm through the rollout kernel: the K swarms as
    one B = K solve, each stencil gathered at its own hypothesis against the
    one shared snapshot, then the exact-cost merge, across the ranks of
    ``mesh`` along ``axis_name`` when one is named.  ``score_dtype`` "bf16"
    and ``rng_mode`` "native" take the ``rollout_bf16`` / ``rollout_turbo``
    kernel modes (K2's mode of that pair in ``models/solve.py:MODES``).
    Returns the single best (pose [3], exact cost []) in the caller's
    dtype."""
    mode = next((name for name, m in MODES.items()
                 if m.kernel == "k2" and (m.score_dtype, m.rng_mode) == (score_dtype, rng_mode)),
                None)
    if mode is None:
        raise ValueError(f"unknown score_dtype {score_dtype!r} or rng_mode {rng_mode!r}")
    k = guesses.shape[0]
    g = guesses.to(torch.float32)
    devs = torch.as_tensor(deviation, dtype=torch.float32).to(g.device).expand(k, 3)
    poses, _ = solve_rollout_mode(mode, keys, g, devs, snap, points.expand(k, -1, -1),
                                  valid.expand(k, -1), map_cfg, cfg, early_exit)
    exact = cost_mod.ndt_cost(poses, snap, points, valid, map_cfg)  # [K]
    best_pose, best_cost = _global_merge(poses, exact, mesh, _axes(axis_name))
    return PsoResult(pose=best_pose.to(guesses.dtype), cost=best_cost.to(guesses.dtype))
