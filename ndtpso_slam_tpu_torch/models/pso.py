"""Particle-swarm SE(2) pose optimization.

Port of ``pso_solve`` in ``ndtpso_slam_tpu/models/pso.py``
(``pso_optimization``, ``core.cpp:50-116``), synchronous-gbest variant: every
particle sees the global best from the end of the previous iteration, the
merge takes the first minimal index, and every improvement test is a strict
``<``.  Randomness follows the frozen Threefry protocol of
:mod:`ndtpso_slam_tpu_torch.ops.rng`; all draws of a solve are made in one
batch up front.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ndtpso_slam_tpu_torch.config import PSOConfig, ZERO_DEVIATION
from ndtpso_slam_tpu_torch.ops import rng

# cost_fn(poses [P, 3], bind_pose [3]) -> costs [P].  The exact costs ignore
# the bind pose (the current global best).
CostFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class PsoResult(NamedTuple):
    pose: torch.Tensor  # [3] best pose found
    cost: torch.Tensor  # [] its cost


def _select_min(cost: torch.Tensor, pos: torch.Tensor):
    """(min cost, pos row at the first argmin) along the particle axis.

    cost: [..., P]; pos: [..., P, K].  A NaN cost makes the minimum NaN and
    the row all zeros, as in the JAX package; a NaN minimum never wins a
    strict ``<`` test, so the row is never used then."""
    p = cost.shape[-1]
    m = torch.amin(cost, dim=-1, keepdim=True)
    iota = torch.arange(p, device=cost.device)
    first = torch.where(cost == m, iota, p).amin(dim=-1, keepdim=True)  # [..., 1]
    idx = first.clamp(max=p - 1)[..., None].expand(*pos.shape[:-2], 1, pos.shape[-1])
    row = torch.gather(pos, -2, idx).squeeze(-2)
    row = torch.where(first < p, row, torch.zeros((), dtype=pos.dtype, device=pos.device))
    return m[..., 0], row


def pso_draws(key, population: int, iterations: int, dtype, device):
    """Every uniform a solve consumes, in the frozen counter protocol.

    Returns (u_gbest [3], u_pop [P, 3], r1 [I, P, 3], r2 [I, P, 3])."""
    base = rng.pso_iter_pair_base(population)
    ctr = torch.arange(base + iterations * 3 * population, dtype=torch.int64, device=device)
    lo, hi = rng.uniform_pairs(key, ctr, dtype)
    return (
        lo[:3],
        lo[3:base].reshape(population, 3),
        lo[base:].reshape(iterations, population, 3),
        hi[base:].reshape(iterations, population, 3),
    )


def pso_solve(
    key,
    guess: torch.Tensor,
    deviation: torch.Tensor,
    cost_fn: CostFn,
    cfg: PSOConfig,
    early_exit: int = 0,
) -> PsoResult:
    """Run one PSO scan-match solve.

    key: (k0, k1) u32 words of this solve.  guess: [3] initial pose.
    deviation: [3] uniform init radius per dimension (``core.cpp:13-23``).
    early_exit: stop once the global best has not improved for this many
    consecutive iterations (0 = the fixed budget); it mirrors the rollout
    kernels' option and reads the global best cost on the host each
    iteration."""
    dtype, dev = guess.dtype, guess.device
    p = cfg.population
    zero_dev = torch.tensor(ZERO_DEVIATION, dtype=dtype, device=dev)
    u_g, u_p, r1s, r2s = pso_draws(key, p, cfg.iterations, dtype, dev)

    # Global-best seed: the guess jittered by a near-zero deviation
    # (core.cpp:53-58), scored on its own.
    g_pos = guess + (2.0 * u_g - 1.0) * zero_dev
    g_cost = cost_fn(g_pos[None, :], guess)[0]

    # Population init: uniform in guess ± deviation (core.cpp:60-69).
    pos = guess + (2.0 * u_p - 1.0) * deviation.to(dtype)
    cost = cost_fn(pos, guess)
    bc, bp = _select_min(cost, pos)
    improved = bc < g_cost
    gbest = torch.where(improved, bp, g_pos)
    gbest_cost = torch.where(improved, bc, g_cost)

    vel = torch.zeros_like(pos)
    pbest, pbest_cost = pos, cost
    w = torch.tensor(cfg.w, dtype=dtype, device=dev)
    stale = 0
    for i in range(cfg.iterations):
        if early_exit > 0 and stale >= early_exit:
            break
        # Velocity/position update (core.cpp:84-89).
        vel = w * vel + cfg.c1 * r1s[i] * (pbest - pos) + cfg.c2 * r2s[i] * (gbest - pos)
        pos = pos + vel
        cost = cost_fn(pos, gbest)
        # pbest then gbest reductions (core.cpp:94-105).
        better = cost < pbest_cost
        pbest = torch.where(better[:, None], pos, pbest)
        pbest_cost = torch.where(better, cost, pbest_cost)
        bc, bp = _select_min(pbest_cost, pbest)
        gimp = bc < gbest_cost
        gbest = torch.where(gimp, bp, gbest)
        gbest_cost = torch.where(gimp, bc, gbest_cost)
        w = w * cfg.w_damping
        if early_exit > 0:
            stale = 0 if bool(gimp) else stale + 1
    return PsoResult(pose=gbest, cost=gbest_cost)
