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
counterpart.

Sharding over ranks (``torch.distributed``, ``parallel/runtime.py``):
:func:`make_mesh` is the flat mesh of the world's ranks,
:func:`make_sharded_solver` runs :func:`solve_batch` on each rank's rows
(one rank, one device: a rollout mode makes one kernel launch per call and
rank, ``fast_fused`` its 52), and :func:`solve_batch_sharded` gathers the
rows back.  Solves are independent, so a solve needs no collective, and each
row keeps its own key.
"""

from __future__ import annotations

import itertools

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.models.pso import OPTIMIZERS, PsoResult, pso_solve_batch
from ndtpso_slam_tpu_torch.ops.rollout import solve_rollout_mode
from ndtpso_slam_tpu_torch.parallel import runtime
from ndtpso_slam_tpu_torch.utils import profiling

SOLVE_AXIS = "solves"
_CALLS = itertools.count()
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


def make_mesh(n_devices=None, axis=SOLVE_AXIS, device="cuda") -> runtime.Mesh:
    """The flat mesh of the world's ranks on one axis (``n_devices``, when
    given, must be the world size), each rank on its own device
    (``runtime.rank_device``)."""
    return runtime.mesh_over((axis,), (n_devices or runtime.world_size(),), device)


def make_sharded_solver(mesh: runtime.Mesh, map_cfg: MapConfig, pso_cfg: PSOConfig,
                        cost_mode="fast", shared_map=False, axes=SOLVE_AXIS, early_exit=0):
    """A solve over this rank's rows of a batch sharded over ``axes`` (the
    flat axis, or ``runtime.SOLVE_AXES`` on the hosts x chips mesh):
    ``(keys, guesses, deviations, snaps, points, valid) -> PsoResult`` of
    the same rows.  With ``shared_map=True`` every solve reads one
    replicated snapshot [C, ...]; otherwise the snapshots are the rows'
    own, stacked [B/D, C, ...].  ``axes`` is only validated: the caller
    cuts its rows with ``runtime.shard_rows``."""
    mesh.axis_names(axes)
    if cost_mode not in COST_MODES:
        raise ValueError(
            f"unknown cost_mode {cost_mode!r}; expected one of {sorted(COST_MODES)}"
        )

    def solve(keys, guesses, deviations, snaps, points, valid) -> PsoResult:
        if (snaps.built.dim() == 1) != shared_map:
            raise ValueError(f"shared_map={shared_map} but the snapshot's built is "
                             f"{tuple(snaps.built.shape)}")
        return solve_batch(keys, guesses, deviations, snaps, points, valid, map_cfg, pso_cfg,
                           cost_mode, early_exit=early_exit)

    return solve


def solve_batch_sharded(mesh: runtime.Mesh, keys, guesses, deviations, snaps, points, valid,
                        map_cfg: MapConfig, pso_cfg: PSOConfig, cost_mode="fast",
                        shared_map=False) -> PsoResult:
    """One sharded solve: this rank's rows in, the whole batch out on every
    rank (its rows gathered in rank order over the flat axis)."""
    solver = make_sharded_solver(mesh, map_cfg, pso_cfg, cost_mode, shared_map,
                                 axes=mesh.axes)
    res = solver(keys, guesses, deviations, snaps, points, valid)
    return PsoResult(*runtime.gather_global(mesh, tuple(res), mesh.axes))


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
    snaps: MapSnapshot,  # stacked [B, C, ...], or one shared [C, ...]
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
    # The call's root span; its request id counts the process's calls.
    with profiling.span("batch.call", next(_CALLS)):
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
            nbrs = cost_mod.bind_neighborhood(guesses, snaps, points, valid, map_cfg,
                                              STENCIL_RADIUS)

            def batched_cost(poses, binds):
                bound = cost_mod.bind_points_local(binds, nbrs, points, map_cfg)
                return cost_mod.bound_cost_fused(poses, bound)

            return pso_solve_batch(keys, guesses, deviations, batched_cost, pso_cfg)
        keys = keys.to(torch.int64).cpu() & 0xFFFFFFFF
        shared = snaps.built.dim() == 1
        results = [
            _solve_one(
                (int(keys[b, 0]), int(keys[b, 1])), guesses[b], deviations[b],
                snaps if shared else MapSnapshot(mean=snaps.mean[b], inv_cov=snaps.inv_cov[b],
                                                 built=snaps.built[b]),
                points[b], valid[b], map_cfg, pso_cfg, cost_mode, optimizer,
            )
            for b in range(guesses.shape[0])
        ]
        return PsoResult(
            pose=torch.stack([r.pose for r in results]), cost=torch.stack([r.cost for r in results])
        )
