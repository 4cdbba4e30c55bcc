"""How each cost mode is solved: the one table of cost modes, the one check
of a mode and an optimizer, the per-solve cost closures and the call of a
whole-solve kernel.

A cost mode (``SlamConfig.cost_mode``, ``solve_batch``'s ``cost_mode``)
names one of three ways to solve a scan match (:data:`MODES`):

* ``"cost"``: a cost closure per solve (:func:`cost_fn`) for ``pso_solve``
  or GLIR-PSO;
* ``"batch"``: one ``[B, P]`` cost (:func:`cost_fn` on stacked inputs) for
  ``pso_solve_batch``, scored by the fused kernel K3 (``ops/score.py``);
* ``"kernel"``: one launch of a whole-solve kernel for the B solves
  (:func:`solve_rollout_mode`): K1 (``ops/rollout_local.py``) or K2
  (``ops/rollout.py``), with the mode's draw stream and scoring dtype.

The modes the SLAM node takes are the JAX package's ``SLAM_COST_MODES``;
batch scan matching takes every mode, the JAX package's ``COST_MODES``.
The kernels run the deployed PSO update rule only, so GLIR-PSO runs the
``"cost"`` modes alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.pso import OPTIMIZERS
from ndtpso_slam_tpu_torch.ops import rollout, rollout_local
from ndtpso_slam_tpu_torch.utils import profiling


class Mode(NamedTuple):
    solve: str  # "cost" | "batch" | "kernel"
    node: bool  # the SLAM node takes it
    kernel: Optional[str] = None  # "k1" | "k2" for a "kernel" mode
    rng_mode: str = "threefry"  # a kernel's draw stream: "threefry" | "native" (turbo)
    score_dtype: str = "f32"  # K2's scoring operands: "f32" | "bf16"


MODES = {
    "exact": Mode("cost", True),
    "fast": Mode("cost", True),
    "fast_local": Mode("cost", True),
    "local_exact": Mode("cost", True),
    "fast_matmul": Mode("cost", False),
    "fast_fused": Mode("batch", False),
    "fast_local_fused": Mode("batch", False),
    "rollout": Mode("kernel", True, "k2"),
    "rollout_bf16": Mode("kernel", True, "k2", score_dtype="bf16"),
    "rollout_turbo": Mode("kernel", True, "k2", "native"),
    "rollout_turbo_bf16": Mode("kernel", True, "k2", "native", "bf16"),
    "rollout_local": Mode("kernel", True, "k1"),
    "rollout_local_turbo": Mode("kernel", True, "k1", "native"),
}
NODE_MODES = tuple(name for name, mode in MODES.items() if mode.node)


def check(cost_mode: str, optimizer: str = "pso", node: bool = False) -> Mode:
    """The mode's entry, or ValueError for an unknown mode (of the node's
    modes with ``node``) or optimizer, or GLIR-PSO with a kernel mode."""
    modes = NODE_MODES if node else MODES
    if cost_mode not in modes:
        raise ValueError(f"unknown cost_mode {cost_mode!r}; expected one of {tuple(modes)}")
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; expected 'pso' | 'glir'")
    mode = MODES[cost_mode]
    if optimizer != "pso" and mode.solve != "cost":
        raise ValueError(
            f"optimizer={optimizer!r} runs through the per-solve cost modes only: the rollout "
            f"and fused kernels implement the deployed PSO update rule ({cost_mode!r})"
        )
    return mode


def cost_fn(cost_mode: str, snap, points: torch.Tensor, valid: torch.Tensor,
            map_cfg: MapConfig, guess: torch.Tensor):
    """The cost closure ``(poses, binds) -> costs`` of a ``"cost"`` or
    ``"batch"`` mode: poses [P, 3] and a bind pose [3] of one solve
    against its snapshot, points [N, 2] and valid [N], or for a batch mode
    poses [B, P, 3] and binds [B, 3] against stacked inputs.  The local
    modes gather the stencil once at ``guess``; the incumbent rebinds
    within it every iteration."""
    kind = MODES[cost_mode].solve
    if kind == "kernel":
        raise ValueError(f"cost_mode {cost_mode!r} runs a whole-solve kernel, not a cost "
                         "function (solve_rollout_mode)")
    if cost_mode == "exact":
        return lambda poses, bind: cost_mod.ndt_cost(poses, snap, points, valid, map_cfg)
    if cost_mode == "fast_matmul":
        tbl = cost_mod.snapshot_table(snap)
        return lambda poses, bind: cost_mod.bound_cost(
            poses, cost_mod.bind_points_matmul(bind, tbl, points, valid, map_cfg))
    score = cost_mod.bound_cost_fused if kind == "batch" else cost_mod.bound_cost
    if cost_mode in ("fast", "fast_fused"):
        return lambda poses, bind: score(
            poses, cost_mod.bind_points(bind, snap, points, valid, map_cfg))
    nbr = cost_mod.bind_neighborhood(guess, snap, points, valid, map_cfg,
                                     cost_mod.DEFAULT_STENCIL_RADIUS)
    if cost_mode == "local_exact":
        return lambda poses, bind: cost_mod.stencil_exact_cost(poses, nbr, points, map_cfg)
    return lambda poses, bind: score(poses, cost_mod.bind_points_local(bind, nbr, points, map_cfg))


def solve_rollout_mode(
    cost_mode: str,
    keys: torch.Tensor,  # [B, 2] integer u32 words
    guesses: torch.Tensor,  # [B, 3]
    deviations: torch.Tensor,  # [B, 3]
    snaps,  # MapSnapshot: one shared by the B solves, or stacked [B, C, ...]
    points: torch.Tensor,  # [B, N, 2]
    valid: torch.Tensor,  # [B, N]
    map_cfg: MapConfig,
    pso_cfg: PSOConfig,
    early_exit: int = 0,
):
    """B solves in one launch of the whole-solve kernel a ``"kernel"`` mode
    names: K1 (``pso_rollout_local``) or K2 (``pso_rollout``), with the
    mode's draw stream and scoring dtype.  The stencil is gathered at each
    guess.  Returns (pose [B, 3] f32, cost [B])."""
    mode = MODES.get(cost_mode)
    if mode is None or mode.solve != "kernel":
        raise ValueError(f"{cost_mode!r} is not a rollout cost mode")
    radius = cost_mod.DEFAULT_STENCIL_RADIUS
    with profiling.span("solve.bind"):
        nbrs = cost_mod.bind_neighborhood(guesses, snaps, points, valid, map_cfg, radius)
    if mode.kernel == "k1":
        with profiling.span("solve.pack"):
            sten, pts = rollout_local.pack_rollout_local_inputs(nbrs, points)
        return rollout_local.pso_rollout_local(keys, guesses, deviations, sten, pts, pso_cfg,
                                               map_cfg, radius, early_exit, mode.rng_mode)
    with profiling.span("solve.pack"):
        sten, pts = rollout.pack_rollout_inputs(nbrs, points)
    return rollout.pso_rollout(keys, guesses, deviations, sten, pts, pso_cfg, map_cfg, radius,
                               score_dtype=mode.score_dtype, rng_mode=mode.rng_mode,
                               early_exit=early_exit)
