"""Batch scan matching: B independent solves in one call.

Port of ``solve_batch`` of ``ndtpso_slam_tpu/parallel/mesh.py`` on one GPU.
B scan pairs, robots or relocalization hypotheses, each with its own map
snapshot (stacked ``[B, C, ...]``), key, guess and deviation, are solved
together:

* ``rollout``, ``rollout_bf16``, ``rollout_turbo``, ``rollout_turbo_bf16``:
  one launch of the frozen-correspondence rollout kernel (``ops/rollout.py``)
  for the whole batch;
* ``rollout_local``, ``rollout_local_turbo``: one launch of the
  per-particle exact rollout kernel (``ops/rollout_local.py``);
* ``fast_fused``, ``fast_local_fused``: the batched solver
  (``pso_solve_batch``) with the fused scoring kernel (``ops/score.py``) on
  every cost evaluation;
* ``exact``, ``fast``, ``fast_local``, ``fast_matmul``, ``local_exact``:
  plain PyTorch solves, one after another (the JAX package has no kernel for
  them either), with ``optimizer="glir"`` GLIR-PSO solves; the rollout and
  fused modes run the deployed PSO update rule only and refuse GLIR, as in
  the JAX package.

The JAX package's ``ROLLOUT_GRID_BLOCK`` (a TPU toolchain workaround) has no
counterpart.  Sharding over several devices (``make_mesh``,
``make_sharded_solver``, ``solve_batch_sharded``) is not ported yet.
"""

from __future__ import annotations

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.models.pso import OPTIMIZERS, PsoResult, pso_solve_batch
from ndtpso_slam_tpu_torch.ops.rollout import solve_rollout_mode

STENCIL_RADIUS = cost_mod.DEFAULT_STENCIL_RADIUS

# Every cost/solver mode solve_batch dispatches on; an unknown string is
# rejected up front, so a typo cannot run a different kernel.
COST_MODES = frozenset(
    {
        "exact",
        "fast",
        "fast_local",
        "fast_matmul",
        "local_exact",
        "fast_fused",
        "fast_local_fused",
        "rollout",
        "rollout_bf16",
        "rollout_turbo",
        "rollout_turbo_bf16",
        "rollout_local",
        "rollout_local_turbo",
    }
)


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}: sharding solves over several devices is not ported yet (ROADMAP E1)"
    )


def make_mesh(n_devices=None, axis="solves"):
    _not_ported("make_mesh")


def make_sharded_solver(mesh, map_cfg, pso_cfg, cost_mode="fast", shared_map=False,
                        axes="solves", early_exit=0):
    _not_ported("make_sharded_solver")


def solve_batch_sharded(mesh, keys, guesses, deviations, snaps, points, valid, map_cfg,
                        pso_cfg, cost_mode="fast", shared_map=False):
    _not_ported("solve_batch_sharded")


def _solve_one(key, guess, deviation, snap, points, valid, map_cfg, pso_cfg, cost_mode,
               optimizer="pso"):
    """One plain solve in a per-solve cost mode, by ``optimizer``."""
    if cost_mode == "fast":
        cost_fn = lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points(bind, snap, points, valid, map_cfg)
        )
    elif cost_mode == "fast_local":
        nbr = cost_mod.bind_neighborhood(guess, snap, points, valid, map_cfg, STENCIL_RADIUS)
        cost_fn = lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points_local(bind, nbr, points, map_cfg)
        )
    elif cost_mode == "fast_matmul":
        tbl = cost_mod.snapshot_table(snap)
        cost_fn = lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points_matmul(bind, tbl, points, valid, map_cfg)
        )
    elif cost_mode == "local_exact":
        nbr = cost_mod.bind_neighborhood(guess, snap, points, valid, map_cfg, STENCIL_RADIUS)
        cost_fn = lambda poses, bind: cost_mod.stencil_exact_cost(poses, nbr, points, map_cfg)
    else:
        cost_fn = lambda poses, bind: cost_mod.ndt_cost(poses, snap, points, valid, map_cfg)
    return OPTIMIZERS[optimizer](key, guess, deviation, cost_fn, pso_cfg)


def solve_batch(
    keys: torch.Tensor,  # [B, 2] integer u32 words
    guesses: torch.Tensor,  # [B, 3]
    deviations: torch.Tensor,  # [B, 3]
    snaps: MapSnapshot,  # stacked [B, C, ...]
    points: torch.Tensor,  # [B, N, 2]
    valid: torch.Tensor,  # [B, N]
    map_cfg: MapConfig,
    pso_cfg: PSOConfig,
    cost_mode: str = "fast",
    optimizer: str = "pso",
    early_exit: int = 0,
) -> PsoResult:
    """B independent scan-match solves.  Returns pose [B, 3], cost [B].

    ``early_exit`` reaches the rollout kernels only, as in the JAX package."""
    if cost_mode not in COST_MODES:
        raise ValueError(
            f"unknown cost_mode {cost_mode!r}; expected one of {sorted(COST_MODES)}"
        )
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; expected 'pso' | 'glir'")
    if optimizer == "glir" and (cost_mode.startswith("rollout") or cost_mode.endswith("_fused")):
        raise ValueError(
            "optimizer='glir' runs through the per-solve cost modes only "
            "(the rollout/fused kernels implement the deployed PSO update rule)"
        )
    if cost_mode.startswith("rollout"):
        pose, cost = solve_rollout_mode(cost_mode, keys, guesses, deviations, snaps, points,
                                        valid, map_cfg, pso_cfg, early_exit)
        return PsoResult(pose=pose.to(guesses.dtype), cost=cost)
    if cost_mode == "fast_fused":

        def batched_cost(poses, binds):  # [B, P, 3], [B, 3] -> [B, P]
            bound = cost_mod.bind_points(binds, snaps, points, valid, map_cfg)
            return cost_mod.bound_cost_fused(poses, bound)

        return pso_solve_batch(keys, guesses, deviations, batched_cost, pso_cfg)
    if cost_mode == "fast_local_fused":
        nbrs = cost_mod.bind_neighborhood(guesses, snaps, points, valid, map_cfg, STENCIL_RADIUS)

        def batched_cost(poses, binds):
            bound = cost_mod.bind_points_local(binds, nbrs, points, map_cfg)
            return cost_mod.bound_cost_fused(poses, bound)

        return pso_solve_batch(keys, guesses, deviations, batched_cost, pso_cfg)
    keys = keys.to(torch.int64).cpu() & 0xFFFFFFFF
    results = [
        _solve_one(
            (int(keys[b, 0]), int(keys[b, 1])), guesses[b], deviations[b],
            MapSnapshot(mean=snaps.mean[b], inv_cov=snaps.inv_cov[b], built=snaps.built[b]),
            points[b], valid[b], map_cfg, pso_cfg, cost_mode, optimizer,
        )
        for b in range(guesses.shape[0])
    ]
    return PsoResult(
        pose=torch.stack([r.pose for r in results]), cost=torch.stack([r.cost for r in results])
    )
