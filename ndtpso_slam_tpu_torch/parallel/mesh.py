"""Batch scan matching: B independent solves in one call.

Port of ``solve_batch`` of ``ndtpso_slam_tpu/parallel/mesh.py`` on one GPU.
B scan pairs, robots or relocalization hypotheses, each with its own map
snapshot (stacked ``[B, C, ...]``), key, guess and deviation, are solved
together, each cost mode as ``models/solve.py:MODES`` says:

* a ``"kernel"`` mode (``rollout*``): one launch of its whole-solve kernel,
  K1 or K2, for the whole batch;
* a ``"batch"`` mode (``fast_fused``, ``fast_local_fused``): the batched
  solver (``pso_solve_batch``) with the fused scoring kernel
  (``ops/score.py``) on every cost evaluation;
* a ``"cost"`` mode: plain PyTorch solves, one after another (the JAX
  package has no kernel for them either), with ``optimizer="glir"``
  GLIR-PSO solves; the other modes run the deployed PSO update rule only
  and refuse GLIR, as in the JAX package.

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
from ndtpso_slam_tpu_torch.models import solve as solve_mod
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.models.pso import OPTIMIZERS, PsoResult, pso_solve_batch
from ndtpso_slam_tpu_torch.models.solve import solve_rollout_mode
from ndtpso_slam_tpu_torch.parallel import runtime
from ndtpso_slam_tpu_torch.utils import profiling

SOLVE_AXIS = "solves"
_CALLS = itertools.count()

# Every cost/solver mode solve_batch dispatches on (models/solve.py:MODES);
# an unknown string is rejected up front, so a typo cannot run a different
# kernel.
COST_MODES = frozenset(solve_mod.MODES)


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
    solve_mod.check(cost_mode)

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
    kind = solve_mod.check(cost_mode, optimizer).solve
    # The call's root span; its request id counts the process's calls.
    with profiling.span("batch.call", next(_CALLS)):
        if kind == "kernel":
            pose, cost = solve_rollout_mode(cost_mode, keys, guesses, deviations, snaps, points,
                                            valid, map_cfg, pso_cfg, early_exit)
            return PsoResult(pose=pose.to(guesses.dtype), cost=cost)
        if kind == "batch":
            cost_fn = solve_mod.cost_fn(cost_mode, snaps, points, valid, map_cfg, guesses)
            return pso_solve_batch(keys, guesses, deviations, cost_fn, pso_cfg)
        keys = keys.to(torch.int64).cpu() & 0xFFFFFFFF
        shared = snaps.built.dim() == 1
        results = []
        for b in range(guesses.shape[0]):
            snap = snaps if shared else MapSnapshot(mean=snaps.mean[b], inv_cov=snaps.inv_cov[b],
                                                    built=snaps.built[b])
            cost_fn = solve_mod.cost_fn(cost_mode, snap, points[b], valid[b], map_cfg, guesses[b])
            results.append(OPTIMIZERS[optimizer]((int(keys[b, 0]), int(keys[b, 1])), guesses[b],
                                                 deviations[b], cost_fn, pso_cfg))
        return PsoResult(
            pose=torch.stack([r.pose for r in results]), cost=torch.stack([r.cost for r in results])
        )
