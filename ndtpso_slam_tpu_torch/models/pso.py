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


def _first_min(cost: torch.Tensor, pos: torch.Tensor):
    """(min cost [..., 1], pos row at the first argmin [..., 1, K]) along
    the particle axis; :func:`_select_min` without the squeezes, the form
    the PSO loop keeps its global best in.

    cost: [..., P]; pos: [..., P, K].  A NaN cost makes the minimum NaN and
    the row all zeros, as in the JAX package; a NaN minimum never wins a
    strict ``<`` test, so the row is never used then."""
    p = cost.shape[-1]
    m = torch.amin(cost, dim=-1, keepdim=True)
    iota = torch.arange(p, device=cost.device)
    first = torch.where(cost == m, iota, p).amin(dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    idx = first.clamp(max=p - 1).expand(*pos.shape[:-2], 1, pos.shape[-1])
    row = torch.gather(pos, -2, idx)
    row = torch.where(first < p, row, torch.zeros((), dtype=pos.dtype, device=pos.device))
    return m, row


def _select_min(cost: torch.Tensor, pos: torch.Tensor):
    """(min cost [...], pos row at the first argmin [..., K]) along the
    particle axis (:func:`_first_min`)."""
    m, row = _first_min(cost, pos)
    return m[..., 0], row[..., 0, :]


def _check_rng_mode(rng_mode: str) -> None:
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r}; expected one of {RNG_MODES}")


def _key_words(key) -> torch.Tensor:
    """One solve's (k0, k1) u32 words as an int64 tensor [2] on the host."""
    return torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64)


def pso_draws(key, population: int, iterations: int, dtype, device, rng_mode="threefry"):
    """Every uniform one solve consumes, in the stream of ``rng_mode``:
    :func:`_batch_draws` for one key.

    Returns (u_gbest [3], u_pop [P, 3], r1 [I, P, 3], r2 [I, P, 3])."""
    return _batch_draws(_key_words(key).to(device), None, population, dtype, device, rng_mode,
                        iterations)


def pso_solve(
    key,
    guess: torch.Tensor,
    deviation: torch.Tensor,
    cost_fn: CostFn,
    cfg: PSOConfig,
    early_exit: int = 0,
    rng_mode: str = "threefry",
) -> PsoResult:
    """Run one PSO scan-match solve: :func:`pso_solve_batch` for one key,
    with no batch axis.

    key: (k0, k1) u32 words of this solve.  guess: [3] initial pose.
    deviation: [3] uniform init radius per dimension (``core.cpp:13-23``).
    early_exit: stop once the global best has not improved for this many
    consecutive iterations (0 = the fixed budget); it mirrors the rollout
    kernels' option and reads the global best cost on the host each
    iteration.  rng_mode: the draw stream (:data:`RNG_MODES`)."""
    return pso_solve_batch(_key_words(key), guess, deviation, cost_fn, cfg,
                           rng_mode, early_exit)


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
    """Draws of solves with keys [..., 2] (any batch shape; none for one
    solve), in the stream of ``rng_mode``.  For ``i is None``: (u_gbest
    [..., 3], u_pop [..., P, 3]), and with ``count`` also the (r1, r2) of
    iterations 0 .. count - 1, each [..., count, P, 3], from the same pass.
    For an iteration i: its (r1, r2), each [..., P, 3], or with ``count``
    those of iterations i .. i + count - 1, each [..., count, P, 3]."""
    _check_rng_mode(rng_mode)
    if i is not None and count is None:
        return tuple(r[..., 0, :, :] for r in _batch_draws(keys, i, population, dtype, device,
                                                           rng_mode, 1))
    # The key words [...] with n axes of 1 before the counters' axes.
    words = lambda n: keys.reshape(keys.shape[:-1] + (1,) * n + (2,)).unbind(-1)
    if rng_mode == "native":
        j = torch.arange(population, dtype=torch.int64, device=device)
        draws = ()
        if i is None:
            k0, k1 = words(0)
            draws = (rng.philox_uniforms((k0, k1), torch.zeros_like(k0), 0, rng.PHILOX_SEED, dtype),
                     rng.philox_uniforms(words(1), j, 0, rng.PHILOX_INIT, dtype))
        if count is not None:
            first = (i or 0) + 1
            steps = torch.arange(first, first + count, dtype=torch.int64, device=device)[:, None]
            draws += tuple(rng.philox_uniforms(words(2), j, steps, select, dtype)
                           for select in (rng.PHILOX_R1, rng.PHILOX_R2))
        return draws
    if i is not None:
        return rng.uniform_pairs(words(3), rng.pso_iter_pairs(i, population, device, count), dtype)
    # The init's pairs and those of the first ``count`` iterations are one
    # run of counters (ops/rng.py's protocol): one Threefry pass.
    base = rng.pso_iter_pair_base(population)
    ctr = torch.arange(base + (count or 0) * 3 * population, dtype=torch.int64, device=device)
    lo, hi = rng.uniform_pairs(words(1), ctr, dtype)
    init = (lo[..., :3], lo[..., 3:base].reshape(keys.shape[:-1] + (population, 3)))
    if count is None:
        return init
    it = lambda u: u[..., base:].reshape(keys.shape[:-1] + (count, population, 3))
    return init + (it(lo), it(hi))


# pso_solve_batch draws the uniforms of as many iterations at once as keep
# the draw block [B, iterations, P, 3] within this many elements: one
# Threefry pass of ~140 small tensor ops serves them all (the first block
# with the init's), where the step is host-bound on launches (~100 MiB of
# int64 temporaries at most).
DRAW_BLOCK_ELEMS = 1 << 21


def pso_solve_batch(
    keys: torch.Tensor,  # [B, 2] integer u32 words, one key per solve
    guesses: torch.Tensor,  # [B, 3]
    deviations: torch.Tensor,  # [B, 3]
    cost_fn,  # (poses [B, P, 3], binds [B, 3]) -> [B, P]
    cfg: PSOConfig,
    rng_mode: str = "threefry",
    early_exit: int = 0,
    exchange=None,
) -> PsoResult:
    """B independent solves with an explicit batch axis: the PSO loop
    (``core.cpp:50-116``).

    The cost callback sees the whole ``[B, P, 3]`` pose block at once, which
    is what lets the fused scoring kernel run one grid over (solves,
    particle tiles).  Any batch shape works, none included: keys [2], a
    guess [3] and a callback of [P, 3] poses is one solve
    (:func:`pso_solve`).  With ``early_exit`` each solve stops on its own: a
    solve whose best has stalled that many iterations keeps its state while
    the others go on.  With ``exchange`` the solves are the islands of one
    multi-swarm search (``parallel/multi_swarm.py:island_exchange``):
    ``exchange(i, gbest [B, 3], gbest_cost [B])`` runs after the global-best
    update of each iteration i and returns the (pose, cost) the solves
    adopt, [3] and [] or one per solve, or None; the personal bests stay
    local.  Returns pose [B, 3], cost [B]."""
    _check_rng_mode(rng_mode)
    if early_exit > 0 and exchange is not None:
        raise ValueError("early_exit and an exchange cannot be combined")
    dtype, dev = guesses.dtype, guesses.device
    p = cfg.population
    keys = keys.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    zero_dev = torch.tensor(ZERO_DEVIATION, dtype=dtype, device=dev)
    block = max(1, DRAW_BLOCK_ELEMS // (guesses[..., 0].numel() * p * 3))
    u_g, u_p, r1s, r2s = _batch_draws(keys, None, p, dtype, dev, rng_mode,
                                      min(block, cfg.iterations))

    # Global-best seed: the guess jittered by a near-zero deviation
    # (core.cpp:53-58), scored on its own.  The global best is kept as
    # [B, 1, 3] and its cost as [B, 1], the shapes _first_min gives.
    g_pos = (guesses + (2.0 * u_g - 1.0) * zero_dev)[..., None, :]
    g_cost = cost_fn(g_pos, guesses)
    # Population init: uniform in guess ± deviation (core.cpp:60-69).
    pos = guesses[..., None, :] + (2.0 * u_p - 1.0) * deviations.to(dtype)[..., None, :]
    cost = cost_fn(pos, guesses)  # [B, P]
    bc, bp = _first_min(cost, pos)
    improved = bc < g_cost
    gbest = torch.where(improved[..., None], bp, g_pos)
    gbest_cost = torch.where(improved, bc, g_cost)

    vel = torch.zeros_like(pos)
    pbest, pbest_cost = pos, cost
    w = torch.tensor(cfg.w, dtype=dtype, device=dev)
    if early_exit > 0:
        stale = torch.zeros(guesses.shape[:-1], dtype=torch.int32, device=dev)
    for i in range(cfg.iterations):
        if early_exit > 0:
            live = stale < early_exit
            if not bool(live.any()):
                break
        if i and i % block == 0:
            r1s, r2s = _batch_draws(keys, i, p, dtype, dev, rng_mode,
                                    min(block, cfg.iterations - i))
        r1, r2 = r1s[..., i % block, :, :], r2s[..., i % block, :, :]
        # Velocity/position update (core.cpp:84-89).
        n_vel = w * vel + cfg.c1 * r1 * (pbest - pos) + cfg.c2 * r2 * (gbest - pos)
        n_pos = pos + n_vel
        cost = cost_fn(n_pos, gbest[..., 0, :])
        # pbest then gbest reductions (core.cpp:94-105).
        better = cost < pbest_cost
        n_pbest = torch.where(better[..., None], n_pos, pbest)
        n_pbest_cost = torch.where(better, cost, pbest_cost)
        bc, bp = _first_min(n_pbest_cost, n_pbest)
        gimp = bc < gbest_cost
        n_gbest = torch.where(gimp[..., None], bp, gbest)
        n_gbest_cost = torch.where(gimp, bc, gbest_cost)
        merged = None if exchange is None else exchange(i, n_gbest[..., 0, :], n_gbest_cost[..., 0])
        if merged is not None:
            n_gbest = merged[0][..., None, :].expand_as(n_gbest)
            n_gbest_cost = merged[1][..., None].expand_as(n_gbest_cost)
        new = (n_pos, n_vel, n_pbest, n_pbest_cost, n_gbest, n_gbest_cost)
        if early_exit > 0:
            # Stalled solves keep their state: the same as leaving the loop.
            keep = lambda a, b: torch.where(
                live.reshape(live.shape + (1,) * (a.dim() - live.dim())), a, b)
            new = tuple(map(keep, new, (pos, vel, pbest, pbest_cost, gbest, gbest_cost)))
            stale = torch.where(live, torch.where(gimp[..., 0], 0, stale + 1), stale)
        pos, vel, pbest, pbest_cost, gbest, gbest_cost = new
        w = w * cfg.w_damping
    return PsoResult(pose=gbest[..., 0, :], cost=gbest_cost[..., 0])
