"""The relocalization's refine swarms on the card: one launch of the CUDA
kernel ``csrc/reloc_step.cu`` before each launch of the fused scoring kernel
(``ops/score.py``, K3), and one after the last.

Its plain version is the CPU branch of
:func:`ndtpso_slam_tpu_torch.models.slam._refine_hypotheses`:
``pso_solve_batch`` with the frozen cost rebound at each swarm's incumbent
against the window (``cost.bind_points_matmul_window``) or the whole table
(``cost.bind_points_matmul``), scored by ``cost.bound_cost``.  The kernel
keeps the solves' state in one device buffer between launches and writes
K3's operands (features, w, mask) in place.

:func:`reloc_init`, :func:`reloc_step` and :func:`reloc_final` take CUDA
tensors only and raise on anything else before they load the library;
nothing falls back to the plain version.  :func:`refine_solve` runs a whole
batch of solves through them.
``reloc_step.LAUNCHES`` counts kernel launches (the init's too).  The
library is built by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig, ZERO_DEVIATION
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops.score import fused_bound_scores

FEATURES = 15
# The kernel's phases (csrc/reloc_step.cu: Phase).
INIT, STEP, FINAL = 0, 1, 2


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fp = ctypes.POINTER(f)
    lib.ndt_reloc_step.argtypes = ([vp] * 15 + [i] * 5 + [f] * 5 + [fp, fp] + [i] * 4 + [vp])
    lib.ndt_reloc_step.restype = i


LIB = _build.KernelLib("reloc_step", "reloc_step.cu", _bind)


def state_floats(population: int) -> int:
    """Floats of one solve's state (csrc/reloc_step.cu): position, velocity
    and personal best [3, P] each, the personal best's cost [P], the global
    best and its cost."""
    return 10 * population + 4


def inertia(cfg: PSOConfig) -> list:
    """The inertia of each iteration as ``pso_solve_batch`` rounds it: a
    float32 running product by ``w_damping``."""
    w, damping, out = np.float32(cfg.w), np.float32(cfg.w_damping), []
    for _ in range(cfg.iterations):
        out.append(float(w))
        w = np.float32(w * damping)
    return out


@dataclasses.dataclass
class Swarms:
    """One batch of B solves between launches: the state buffer, K3's
    operands (``phit_seed`` [B, 15, 1] and ``phit`` [B, 15, P] the features,
    ``w`` [B, N, 15], ``mask`` [B, N]), the result (``pose`` [B, 3],
    ``cost`` [B], written by the final launch), the launch's constants and
    how far the solves have gone (``folds`` made, ``done`` after the final)."""

    state: torch.Tensor
    keys: torch.Tensor
    guesses: torch.Tensor
    anchor: torch.Tensor
    tbl: torch.Tensor
    points: torch.Tensor
    valid: torch.Tensor
    phit_seed: torch.Tensor
    phit: torch.Tensor
    w: torch.Tensor
    mask: torch.Tensor
    pose: torch.Tensor
    cost: torch.Tensor
    ps: int
    map_cfg: MapConfig
    pso_cfg: PSOConfig
    deviation: Tuple[float, float, float]
    inertia: list
    folds: int = 0
    done: bool = False


def _check(guesses, anchor, tbl, points, valid, map_cfg: MapConfig) -> None:
    """Raise ValueError or TypeError unless every tensor is a contiguous
    CUDA tensor of the kernel's shape and dtype, all on one device."""
    b = guesses.shape[0]
    n = points.shape[0]
    specs = (("guesses", guesses, (b, 3), torch.float32), ("anchor", anchor, (3,), torch.float32),
             ("tbl", tbl, (map_cfg.num_cells, 6), torch.float32),
             ("points", points, (n, 2), torch.float32), ("valid", valid, (n,), torch.bool))
    if b < 1 or n < 1:
        raise ValueError(f"{b} solves of {n} points: the kernel takes at least one of each")
    for name, t, shape, dtype in specs:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not points.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {points.device}")
    for name, t, _, _ in specs:
        if t.device != points.device:
            raise ValueError(f"{name} on {t.device}, points on {points.device}")


def _launch(sw: Swarms, phase: int, it: int = 0, cost: Optional[torch.Tensor] = None,
            cost_seed: Optional[torch.Tensor] = None) -> None:
    """One launch.  Every fold (a step or the final) takes K3's costs of the
    population; the first fold also takes the seeds', and no other does."""
    b, p = sw.state.shape[0], sw.pso_cfg.population
    if sw.done:
        raise ValueError("these solves have had their final launch")
    if phase != INIT:
        if cost is None:
            raise ValueError("a fold takes the population's costs")
        if (cost_seed is None) != (sw.folds > 0):
            raise ValueError("the first fold, and only it, takes the seeds' costs")
    for name, t, shape in (("cost_seed", cost_seed, (b, 1)), ("cost", cost, (b, p))):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected contiguous float32 "
                             f"{shape}")
        if t.device != sw.state.device:
            raise ValueError(f"{name} on {t.device}, the solves on {sw.state.device}")
    lib = _build.load(LIB)
    mc, pc = sw.map_cfg, sw.pso_cfg
    ptr = lambda t: None if t is None else t.data_ptr()
    floats = lambda v: (ctypes.c_float * 3)(*(float(np.float32(x)) for x in v))
    device = sw.state.get_device()
    err = lib.ndt_reloc_step(
        sw.state.data_ptr(), sw.keys.data_ptr(), sw.guesses.data_ptr(), sw.anchor.data_ptr(),
        sw.tbl.data_ptr(), sw.points.data_ptr(), sw.valid.data_ptr(), ptr(cost_seed), ptr(cost),
        sw.phit_seed.data_ptr(), sw.phit.data_ptr(), sw.w.data_ptr(), sw.mask.data_ptr(),
        sw.pose.data_ptr(), sw.cost.data_ptr(), b, p, sw.points.shape[0], sw.ps,
        mc.cells_per_side, float(np.float32(mc.half_size_m)),
        float(np.float32(1.0) / np.float32(mc.cell_side_m)), float(np.float32(pc.c1)),
        float(np.float32(pc.c2)), sw.inertia[it] if phase == STEP else 0.0,
        floats(sw.deviation), floats(ZERO_DEVIATION), it, phase, int(cost_seed is not None),
        device, torch._C._cuda_getCurrentRawStream(device))
    _build.check_launch(lib, err, "reloc_step")
    reloc_step.LAUNCHES += 1
    if phase != INIT:
        sw.folds += 1
    sw.done = phase == FINAL


def reloc_init(keys: torch.Tensor, guesses: torch.Tensor, deviation, tbl: torch.Tensor,
               anchor: torch.Tensor, ps: int, points: torch.Tensor, valid: torch.Tensor,
               map_cfg: MapConfig, pso_cfg: PSOConfig) -> Swarms:
    """The init launch of B solves: keys [B, 2] (u32 words, any integer
    dtype, any device), guesses [B, 3], one deviation (3 floats) for all,
    the [C, 6] table (``cost.snapshot_table``), the window's side ``ps``
    around ``anchor`` [3]'s cell (0: the whole table), the scan's points
    [N, 2] and valid [N].  Writes the features of the seeds and of the
    populations and the bind at the guesses."""
    if not 0 <= ps <= map_cfg.cells_per_side:
        raise ValueError(f"window side {ps}: 0 to {map_cfg.cells_per_side}")
    if pso_cfg.population < 1:
        raise ValueError(f"population {pso_cfg.population}")
    _check(guesses, anchor, tbl, points, valid, map_cfg)
    dev, b, p, n = guesses.device, guesses.shape[0], pso_cfg.population, points.shape[0]
    keys = torch.as_tensor(keys)
    keys = _build.u32_words(keys, keys.device).to(dev)  # words made where the keys are
    if tuple(keys.shape) != (b, 2):
        raise ValueError(f"keys: {tuple(keys.shape)}, expected {(b, 2)}")
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    sw = Swarms(state=f32(b, state_floats(p)), keys=keys, guesses=guesses, anchor=anchor, tbl=tbl,
                points=points, valid=valid, phit_seed=f32(b, FEATURES, 1),
                phit=f32(b, FEATURES, p), w=f32(b, n, FEATURES), mask=f32(b, n), pose=f32(b, 3),
                cost=f32(b), ps=int(ps), map_cfg=map_cfg, pso_cfg=pso_cfg,
                deviation=tuple(deviation), inertia=inertia(pso_cfg))
    _launch(sw, INIT)
    return sw


def reloc_step(sw: Swarms, it: int, cost: torch.Tensor,
               cost_seed: Optional[torch.Tensor] = None) -> None:
    """Fold K3's costs [B, P] of the poses last scored (at the first fold
    also the seeds' [B, 1], ``cost_seed``), then take iteration ``it``:
    update, rebind at each global best, write the features."""
    if not 0 <= it < sw.pso_cfg.iterations:
        raise ValueError(f"iteration {it} of {sw.pso_cfg.iterations}")
    _launch(sw, STEP, it, cost, cost_seed)


def reloc_final(sw: Swarms, cost: torch.Tensor, cost_seed: Optional[torch.Tensor] = None) -> None:
    """Fold K3's last costs (as :func:`reloc_step`) and write the result
    into ``sw.pose`` and ``sw.cost``."""
    _launch(sw, FINAL, 0, cost, cost_seed)


reloc_step.LAUNCHES = 0


def refine_solve(keys, guesses, deviation, tbl, anchor, ps, points, valid, map_cfg: MapConfig,
                 pso_cfg: PSOConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """B solves of ``pso_solve_batch`` on the frozen cost rebound at each
    solve's incumbent (arguments as :func:`reloc_init`): I + 2 launches of
    the kernel and I + 2 of K3.  Returns (pose [B, 3], cost [B])."""
    sw = reloc_init(keys, guesses, deviation, tbl, anchor, ps, points, valid, map_cfg, pso_cfg)
    cost_seed = fused_bound_scores(sw.phit_seed, sw.w, sw.mask)
    cost = fused_bound_scores(sw.phit, sw.w, sw.mask)
    for i in range(pso_cfg.iterations):
        reloc_step(sw, i, cost, cost_seed)
        cost_seed = None
        cost = fused_bound_scores(sw.phit, sw.w, sw.mask)
    reloc_final(sw, cost, cost_seed)
    return sw.pose, sw.cost
