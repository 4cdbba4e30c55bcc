"""Particle-swarm SE(2) pose optimization.

Port of ``pso_solve``, ``glir_pso_solve`` and ``pso_solve_batch`` in
``ndtpso_slam_tpu/models/pso.py`` (``pso_optimization``, ``core.cpp:50-116``;
GLIR-PSO, ``core.cpp:118-186``), synchronous-gbest variant: every particle
sees the global best from the end of the previous iteration, the merge takes
the first minimal index, and every improvement test is a strict ``<``.
Randomness follows the frozen Threefry protocol of
:mod:`ndtpso_slam_tpu_torch.ops.rng` (``rng_mode="threefry"``), or its Philox
layout for the turbo modes (``rng_mode="native"``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ndtpso_slam_tpu_torch.config import PSOConfig, ZERO_DEVIATION
from ndtpso_slam_tpu_torch.ops import rng

# cost_fn(poses [P, 3], bind_pose [3]) -> costs [P].  The exact costs ignore
# the bind pose (the current global best).
CostFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# "threefry": the frozen parity stream; "native": the turbo modes' Philox
# stream (the JAX package's TPU hardware generator has no GPU counterpart).
RNG_MODES = ("threefry", "native")


class PsoResult(NamedTuple):
    pose: torch.Tensor  # [..., 3] best pose found
    cost: torch.Tensor  # [...] its cost


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


def _check_rng_mode(rng_mode: str) -> None:
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r}; expected one of {RNG_MODES}")


def pso_draws(key, population: int, iterations: int, dtype, device, rng_mode="threefry"):
    """Every uniform one solve consumes, in the stream of ``rng_mode``.

    Returns (u_gbest [3], u_pop [P, 3], r1 [I, P, 3], r2 [I, P, 3])."""
    _check_rng_mode(rng_mode)
    if rng_mode == "native":
        j = torch.arange(population, dtype=torch.int64, device=device)
        steps = torch.arange(1, iterations + 1, dtype=torch.int64, device=device)[:, None]
        return (
            rng.philox_uniforms(key, j[:1] * 0, 0, rng.PHILOX_SEED, dtype)[0],
            rng.philox_uniforms(key, j, 0, rng.PHILOX_INIT, dtype),
            rng.philox_uniforms(key, j[None, :], steps, rng.PHILOX_R1, dtype),
            rng.philox_uniforms(key, j[None, :], steps, rng.PHILOX_R2, dtype),
        )
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
    rng_mode: str = "threefry",
) -> PsoResult:
    """Run one PSO scan-match solve.

    key: (k0, k1) u32 words of this solve.  guess: [3] initial pose.
    deviation: [3] uniform init radius per dimension (``core.cpp:13-23``).
    early_exit: stop once the global best has not improved for this many
    consecutive iterations (0 = the fixed budget); it mirrors the rollout
    kernels' option and reads the global best cost on the host each
    iteration.  rng_mode: the draw stream (:data:`RNG_MODES`)."""
    dtype, dev = guess.dtype, guess.device
    p = cfg.population
    zero_dev = torch.tensor(ZERO_DEVIATION, dtype=dtype, device=dev)
    u_g, u_p, r1s, r2s = pso_draws(key, p, cfg.iterations, dtype, dev, rng_mode)

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


def glir_pso_solve(
    key,
    guess: torch.Tensor,
    deviation: torch.Tensor,
    cost_fn: CostFn,
    cfg: PSOConfig,
) -> PsoResult:
    """One GLIR-PSO solve (JAX ``glir_pso_solve``, ``pso.py:135-216``): the
    inertia and the coefficients adapted from the global-best / personal-best
    cost ratios, ratio-weighted attractors (``core.cpp:146-153``), with the
    JAX package's two departures from the untested upstream code: the
    running personal-best average is taken over iterations, not divided by
    the particle index, and the swarm runs in coordinates relative to the
    guess.  The Threefry draws are :func:`pso_solve`'s; the 1e-12 guards
    keep every ratio finite."""
    dtype, dev = guess.dtype, guess.device
    p = cfg.population
    zero_dev = torch.tensor(ZERO_DEVIATION, dtype=dtype, device=dev)
    u_g, u_p, r1s, r2s = pso_draws(key, p, cfg.iterations, dtype, dev)
    shift = guess

    def rel_cost(poses, bind):
        return cost_fn(poses + shift, bind + shift)

    zero3 = torch.zeros_like(guess)
    g_pos = (2.0 * u_g - 1.0) * zero_dev
    g_cost = rel_cost(g_pos[None, :], zero3)[0]
    pos = (2.0 * u_p - 1.0) * deviation.to(dtype)
    cost = rel_cost(pos, zero3)
    bc, bp = _select_min(cost, pos)
    improved = bc < g_cost
    gbest = torch.where(improved, bp, g_pos)
    gbest_cost = torch.where(improved, bc, g_cost)

    eps = torch.tensor(1e-12, dtype=dtype, device=dev)
    guard = lambda v: torch.where(torch.abs(v) > eps, v, eps)
    vel = torch.zeros_like(pos)
    pbest, pbest_cost, pbest_sum = pos, cost, cost
    for i in range(cfg.iterations):
        pbest_avg = pbest_sum / float(i + 1)
        omega = 1.1 - gbest_cost / guard(pbest_avg)  # [P]
        cc = 1.0 + gbest_cost / guard(pbest_cost)  # c1 == c2, core.cpp:147
        ratio = pbest / guard(gbest)  # [P, 3]
        inv_ratio = torch.where(torch.abs(ratio) > eps, 1.0 / ratio, 0.0)
        vel = (omega[:, None] * vel
               + cc[:, None] * r1s[i] * (ratio * pbest - pos)
               + cc[:, None] * r2s[i] * (inv_ratio * gbest - pos))
        pos = pos + vel
        cost = rel_cost(pos, gbest)
        better = cost < pbest_cost
        pbest = torch.where(better[:, None], pos, pbest)
        pbest_cost = torch.where(better, cost, pbest_cost)
        pbest_sum = pbest_sum + pbest_cost
        bc, bp = _select_min(pbest_cost, pbest)
        gimp = bc < gbest_cost
        gbest = torch.where(gimp, bp, gbest)
        gbest_cost = torch.where(gimp, bc, gbest_cost)
    return PsoResult(pose=gbest + shift, cost=gbest_cost)


# The single-solve optimizers, by SlamConfig.optimizer.
OPTIMIZERS = {"pso": pso_solve, "glir": glir_pso_solve}


def _batch_draws(keys: torch.Tensor, i, population: int, dtype, device, rng_mode, count=None):
    """Draws of B solves at once: (u_gbest [B, 3], u_pop [B, P, 3]) for
    ``i is None``, else iteration i's (r1, r2), each [B, P, 3], or with
    ``count`` those of iterations i .. i + count - 1, each [B, count, P, 3];
    the same values :func:`pso_draws` gives each solve."""
    if i is not None and count is None:
        return tuple(r[:, 0] for r in _batch_draws(keys, i, population, dtype, device,
                                                   rng_mode, 1))
    k0, k1 = keys[:, 0], keys[:, 1]
    if rng_mode == "native":
        j = torch.arange(population, dtype=torch.int64, device=device)
        if i is None:
            kb = (k0[:, None], k1[:, None])
            return (
                rng.philox_uniforms((k0, k1), torch.zeros_like(k0), 0, rng.PHILOX_SEED, dtype),
                rng.philox_uniforms(kb, j, 0, rng.PHILOX_INIT, dtype),
            )
        kb = (k0[:, None, None], k1[:, None, None])
        steps = torch.arange(i + 1, i + 1 + count, dtype=torch.int64, device=device)[:, None]
        return (
            rng.philox_uniforms(kb, j, steps, rng.PHILOX_R1, dtype),
            rng.philox_uniforms(kb, j, steps, rng.PHILOX_R2, dtype),
        )
    if i is None:
        kb = (k0[:, None, None], k1[:, None, None])
        g_ctr, p_ctr = rng.pso_init_pairs(population, device)
        return (
            rng.uniform_pairs((k0[:, None], k1[:, None]), g_ctr, dtype)[0],
            rng.uniform_pairs(kb, p_ctr, dtype)[0],
        )
    kb = (k0[:, None, None, None], k1[:, None, None, None])
    return rng.uniform_pairs(kb, rng.pso_iter_pairs(i, population, device, count), dtype)


# pso_solve_batch draws the uniforms of as many iterations at once as keep
# the draw block [B, iterations, P, 3] within this many elements: one
# Threefry pass of ~140 small tensor ops serves them all, where the step is
# host-bound on launches (~100 MiB of int64 temporaries at most).
DRAW_BLOCK_ELEMS = 1 << 21


def pso_solve_batch(
    keys: torch.Tensor,  # [B, 2] integer u32 words, one key per solve
    guesses: torch.Tensor,  # [B, 3]
    deviations: torch.Tensor,  # [B, 3]
    cost_fn,  # (poses [B, P, 3], binds [B, 3]) -> [B, P]
    cfg: PSOConfig,
    rng_mode: str = "threefry",
    early_exit: int = 0,
    exchange_every: int = 0,
) -> PsoResult:
    """B independent solves with an explicit batch axis.

    The same per-solve streams and update rule as a loop of
    :func:`pso_solve`, but the cost callback sees the whole ``[B, P, 3]``
    pose block at once, which is what lets the fused scoring kernel run one
    grid over (solves, particle tiles).  With ``early_exit`` each solve stops
    on its own: a solve whose best has stalled that many iterations keeps its
    state while the others go on.  With ``exchange_every`` = e > 0 the solves
    are the islands of one multi-swarm search (``parallel/multi_swarm.py``):
    after the global-best update of iteration i, when (i + 1) % e == 0, every
    solve adopts the best incumbent of the batch (first minimum), while the
    personal bests stay local.  Returns pose [B, 3], cost [B]."""
    _check_rng_mode(rng_mode)
    if early_exit > 0 and exchange_every > 0:
        raise ValueError("early_exit and exchange_every cannot be combined")
    dtype, dev = guesses.dtype, guesses.device
    p = cfg.population
    keys = keys.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    zero_dev = torch.tensor(ZERO_DEVIATION, dtype=dtype, device=dev)

    u_g, u_p = _batch_draws(keys, None, p, dtype, dev, rng_mode)
    g_pos = guesses + (2.0 * u_g - 1.0) * zero_dev  # [B, 3]
    g_cost = cost_fn(g_pos[:, None, :], guesses)[:, 0]  # [B]
    pos = guesses[:, None, :] + (2.0 * u_p - 1.0) * deviations.to(dtype)[:, None, :]
    cost = cost_fn(pos, guesses)  # [B, P]
    bc, bp = _select_min(cost, pos)
    improved = bc < g_cost
    gbest = torch.where(improved[:, None], bp, g_pos)
    gbest_cost = torch.where(improved, bc, g_cost)

    vel = torch.zeros_like(pos)
    pbest, pbest_cost = pos, cost
    w = torch.tensor(cfg.w, dtype=dtype, device=dev)
    stale = torch.zeros(guesses.shape[0], dtype=torch.int32, device=dev)
    block = max(1, DRAW_BLOCK_ELEMS // (guesses.shape[0] * p * 3))
    for i in range(cfg.iterations):
        if early_exit > 0:
            live = stale < early_exit
            if not bool(live.any()):
                break
        if i % block == 0:
            r1s, r2s = _batch_draws(keys, i, p, dtype, dev, rng_mode,
                                    min(block, cfg.iterations - i))
        r1, r2 = r1s[:, i % block], r2s[:, i % block]
        n_vel = w * vel + cfg.c1 * r1 * (pbest - pos) + cfg.c2 * r2 * (gbest[:, None, :] - pos)
        n_pos = pos + n_vel
        cost = cost_fn(n_pos, gbest)
        better = cost < pbest_cost
        n_pbest = torch.where(better[..., None], n_pos, pbest)
        n_pbest_cost = torch.where(better, cost, pbest_cost)
        bc, bp = _select_min(n_pbest_cost, n_pbest)
        gimp = bc < gbest_cost
        n_gbest = torch.where(gimp[:, None], bp, gbest)
        n_gbest_cost = torch.where(gimp, bc, gbest_cost)
        if exchange_every > 0 and (i + 1) % exchange_every == 0:
            mc, mp = _select_min(n_gbest_cost, n_gbest)
            n_gbest, n_gbest_cost = mp.expand_as(n_gbest), mc.expand_as(n_gbest_cost)
        new = (n_pos, n_vel, n_pbest, n_pbest_cost, n_gbest, n_gbest_cost)
        if early_exit > 0:
            # Stalled solves keep their state: the same as leaving the loop.
            keep = lambda a, b: torch.where(live.view(-1, *([1] * (a.dim() - 1))), a, b)
            new = tuple(map(keep, new, (pos, vel, pbest, pbest_cost, gbest, gbest_cost)))
            stale = torch.where(live, torch.where(gimp, 0, stale + 1), stale)
        pos, vel, pbest, pbest_cost, gbest, gbest_cost = new
        w = w * cfg.w_damping
    return PsoResult(pose=gbest, cost=gbest_cost)
