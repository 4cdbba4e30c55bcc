"""Whole-solve PSO with correspondences frozen at the incumbent: the CUDA
kernel ``csrc/rollout.cu``, its plain PyTorch version, and the input packer.

Port of ``pack_rollout_inputs`` / ``pso_rollout`` / ``_rollout_kernel`` of
``ndtpso_slam_tpu/ops/pallas_rollout.py``, every branch: ``score_dtype``
f32 | bf16, ``rng_mode`` threefry | native (turbo: Philox, see
``ops/rng.py``), ``exp_mode`` exp | exp2 | approx, and the early exit.  The
kernel runs one whole solve per thread block (see the note at the top of the
``.cu`` file).

:func:`pso_rollout` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back from
one to the other.  ``pso_rollout.LAUNCHES`` counts kernel launches.  The
library is built by ``ops/_build.py``.  :func:`solve_rollout_mode` maps a
``rollout*`` cost mode to its kernel call, for batch scan matching and the
SLAM align alike.
"""

from __future__ import annotations

import ctypes

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig, ZERO_DEVIATION
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.pso import RNG_MODES, pso_solve_batch
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops.geometry import cell_coords
from ndtpso_slam_tpu_torch.ops.rollout_local import (
    BIG,
    EXP2_SCALE,
    default_exp_mode,
    pack_rollout_local_inputs,
    pso_rollout_local,
)

EXP_MODES = ("exp", "exp2", "approx")
SCORE_DTYPES = ("f32", "bf16")
# Schraudolph's 2^x (exp_mode="approx"): the exponent bias with the JAX
# package's tuned offset.
_APPROX_BIAS = 127 * (1 << 23) - 366393


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ndt_rollout.argtypes = [vp] * 6 + [i] * 9 + [f] * 9 + [vp]
    lib.ndt_rollout.restype = i
    lib.ndt_rollout_smem_bytes.argtypes = [i]
    lib.ndt_rollout_smem_bytes.restype = ctypes.c_size_t
    lib.ndt_rollout_max_population.argtypes = []
    lib.ndt_rollout_max_population.restype = i


LIB = _build.KernelLib("rollout", "rollout.cu", _bind)


def pack_rollout_inputs(nbr: cost_mod.NeighborhoodBind, points: torch.Tensor):
    """Repack a NeighborhoodBind and its points [..., N, 2] into the kernel's
    layouts, points on the last axis as in the JAX package: stencil
    [..., K2, 8, N] (rows mx, my, la, lb, lc, built, 0, 0) and points
    [..., 8, N] (rows px, py, anchor_ix, anchor_iy, valid, 0, 0, 0).

    Unlike the JAX packer, the statistics of unbuilt lanes are zeroed by a
    select, as K1's packer does: they may hold inf or NaN inverse
    covariances, which the JAX kernel's one-hot select can turn into a NaN
    cost (0 · inf) even when the lane is never selected."""
    f32 = torch.float32
    dev = points.device
    built = nbr.built[..., None]  # [..., N, K2, 1]
    zero = torch.zeros((), dtype=f32, device=dev)
    cols = torch.cat(
        [
            torch.where(built, nbr.mean.to(f32), zero),
            torch.where(built, nbr.icov.to(f32), zero),
            built.to(f32),
            torch.zeros((*nbr.built.shape, 2), dtype=f32, device=dev),
        ],
        dim=-1,
    )  # [..., N, K2, 8]
    sten = cols.movedim(-3, -1).contiguous()  # [..., K2, 8, N]
    z = torch.zeros(nbr.valid.shape, dtype=f32, device=dev)
    pts = torch.stack(
        [
            points[..., 0].to(f32),
            points[..., 1].to(f32),
            nbr.anchor_ix.to(f32),
            nbr.anchor_iy.to(f32),
            nbr.valid.to(f32),
            z, z, z,
        ],
        dim=-2,
    )  # [..., 8, N]
    return sten, pts


def packed_bind(
    binds: torch.Tensor,  # [B, 3]
    sten: torch.Tensor,  # [B, K2, 8, N]
    pts: torch.Tensor,  # [B, 8, N]
    map_cfg: MapConfig,
    radius: int,
):
    """The kernel's point binding at the binding pose (``bind_points_local``):
    the rotated points rx, ry [B, N], each point's stencil lane [B, 8, N]
    (its cell's row of the 25-cell stencil; rows mx, my, la, lb, lc, built)
    and the validity mask [B, N] (built, in the frame, valid; 0 outside the
    stencil)."""
    f32 = torch.float32
    side = 2 * radius + 1
    bx, by = binds[:, 0:1], binds[:, 1:2]
    c0, s0 = torch.cos(binds[:, 2:3]), torch.sin(binds[:, 2:3])
    px, py = pts[:, 0], pts[:, 1]
    rx = px * c0 - py * s0  # [B, N]
    ry = px * s0 + py * c0
    ix, iy, inb = cell_coords(
        torch.stack([rx + bx, ry + by], dim=-1),
        size_m=map_cfg.size_m, cell_side_m=map_cfg.cell_side_m,
    )
    di = ix - pts[:, 2].to(torch.int32)
    dj = iy - pts[:, 3].to(torch.int32)
    in_st = (di.abs() <= radius) & (dj.abs() <= radius)
    kk = torch.where(in_st, (dj + radius) * side + (di + radius), 0).long()
    lane = sten.gather(1, kk[:, None, None, :].expand(-1, 1, 8, -1))[:, 0]  # [B, 8, N]
    zero = torch.zeros((), dtype=f32, device=pts.device)
    mask = torch.where(in_st, lane[:, 5], zero) * inb.to(f32) * pts[:, 4]
    return rx, ry, lane, mask


def packed_bound_w(
    binds: torch.Tensor,  # [B, 3]
    sten: torch.Tensor,  # [B, K2, 8, N]
    pts: torch.Tensor,  # [B, 8, N]
    map_cfg: MapConfig,
    radius: int,
) -> torch.Tensor:  # [B, N, 15]
    """The kernel's rebind: each point's stencil lane at the binding pose
    (:func:`packed_bind`) and its 15 quadratic-form coefficients
    (``_quadform_bound``), with the mask folded in as the kernel does:
    ``w *= mask`` and ``w14 += (1 - mask) · 1e9``, so a masked point scores
    exp(-5e8) == 0."""
    bx, by = binds[:, 0:1], binds[:, 1:2]
    rx, ry, lane, mask = packed_bind(binds, sten, pts, map_cfg, radius)
    gx = rx + bx - lane[:, 0]
    gy = ry + by - lane[:, 1]
    la, lb, lc = lane[:, 2], lane[:, 3], lane[:, 4]
    one, nil = torch.ones_like(gx), torch.zeros_like(gx)
    brx = (rx, -ry, one, nil, gx)
    bry = (ry, rx, nil, one, gy)
    lbx = [la * brx[a] + lb * bry[a] for a in range(5)]
    lby = [lb * brx[a] + lc * bry[a] for a in range(5)]
    rows = []
    for a, b in cost_mod._IJ:
        m = brx[a] * lbx[b] + bry[a] * lby[b]
        rows.append((m if a == b else 2.0 * m) * mask)
    rows[14] = rows[14] + (1.0 - mask) * BIG
    return torch.stack(rows, dim=-1)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def score_z(z: torch.Tensor, exp_mode: str) -> torch.Tensor:
    """exp(-max(z, 0)/2) in the kernel's three forms."""
    zc = torch.clamp(z, min=0.0)
    if exp_mode == "exp2":
        return torch.exp2(zc * EXP2_SCALE)
    if exp_mode == "approx":
        x = torch.clamp(zc * EXP2_SCALE, min=-126.0)
        return ((x * float(1 << 23)).to(torch.int32) + _APPROX_BIAS).view(torch.float32)
    return torch.exp(-0.5 * zc)


def packed_frozen_cost(
    poses: torch.Tensor,  # [B, P, 3]
    binds: torch.Tensor,  # [B, 3]
    sten: torch.Tensor,
    pts: torch.Tensor,
    map_cfg: MapConfig,
    radius: int = cost_mod.DEFAULT_STENCIL_RADIUS,
    score_dtype: str = "f32",
    exp_mode: str = "exp",
) -> torch.Tensor:  # [B, P]
    """The cost the kernel evaluates: rebind at ``binds``, z = φ·wᵀ (with
    bf16-rounded operands for ``score_dtype="bf16"``), then the sum of
    :func:`score_z` over all points."""
    w = packed_bound_w(binds, sten, pts, map_cfg, radius)
    phi = cost_mod.pose_features(poses, binds)  # [B, P, 15]
    if score_dtype == "bf16":
        w, phi = _bf16(w), _bf16(phi)
    z = phi @ w.transpose(-1, -2)  # [B, P, N]
    return -torch.sum(score_z(z, exp_mode), dim=-1)


def pso_rollout_reference(
    keys, guesses, deviations, sten, pts, cfg: PSOConfig, map_cfg: MapConfig,
    radius: int = cost_mod.DEFAULT_STENCIL_RADIUS, score_dtype: str = "f32",
    rng_mode: str = "threefry", exp_mode=None, early_exit: int = 0,
):
    """Plain PyTorch version of the kernel: ``pso_solve_batch`` over
    :func:`packed_frozen_cost`.  Same arguments and results as
    :func:`pso_rollout`."""
    exp_mode = exp_mode or default_exp_mode(rng_mode)
    res = pso_solve_batch(
        keys, guesses.to(torch.float32), deviations.to(torch.float32),
        lambda poses, binds: packed_frozen_cost(
            poses, binds, sten, pts, map_cfg, radius, score_dtype, exp_mode
        ),
        cfg, rng_mode=rng_mode, early_exit=early_exit,
    )
    return res.pose, res.cost


def _launch(keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, score_dtype,
            rng_mode, exp_mode, early_exit):
    dev = sten.device
    b, k2, rows, n = sten.shape
    for name, t in (("guesses", guesses), ("deviations", deviations), ("pts", pts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, sten on {dev}")
    if sten.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError("sten and pts must be float32")
    if rows != 8 or pts.shape != (b, 8, n) or k2 != (2 * radius + 1) ** 2:
        raise ValueError(f"bad shapes: sten {tuple(sten.shape)}, pts {tuple(pts.shape)}")
    if guesses.shape != (b, 3) or deviations.shape != (b, 3) or keys.shape != (b, 2):
        raise ValueError("keys, guesses and deviations must be [B, 2], [B, 3], [B, 3]")
    lib = _build.load(LIB)
    if cfg.population > lib.ndt_rollout_max_population():
        raise ValueError(
            f"population {cfg.population} > {lib.ndt_rollout_max_population()}, "
            "the most one rollout launch takes"
        )
    smem = lib.ndt_rollout_smem_bytes(n)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"N={n} needs {smem} B of shared memory; the device allows {limit} B")
    sten, pts = sten.contiguous(), pts.contiguous()
    guesses = guesses.to(torch.float32).contiguous()
    deviations = deviations.to(torch.float32).contiguous()
    keys32 = _build.u32_words(keys, dev)
    out = torch.empty((b, 4), dtype=torch.float32, device=dev)
    zd = ZERO_DEVIATION
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_rollout(
            keys32.data_ptr(), guesses.data_ptr(), deviations.data_ptr(),
            sten.data_ptr(), pts.data_ptr(), out.data_ptr(),
            b, n, cfg.population, cfg.iterations, radius, early_exit,
            int(rng_mode == "native"), int(score_dtype == "bf16"), EXP_MODES.index(exp_mode),
            map_cfg.half_size_m, map_cfg.cell_side_m,
            cfg.w, cfg.c1, cfg.c2, cfg.w_damping, zd[0], zd[1], zd[2],
            stream,
        )
    _build.check_launch(lib, err, "rollout")
    pso_rollout.LAUNCHES += 1
    return out[:, 0:3], out[:, 3]


def pso_rollout(
    keys: torch.Tensor,  # [B, 2] integer u32 words
    guesses: torch.Tensor,  # [B, 3] f32
    deviations: torch.Tensor,  # [B, 3] f32
    sten: torch.Tensor,  # [B, K2, 8, N] f32 (pack_rollout_inputs)
    pts: torch.Tensor,  # [B, 8, N] f32
    cfg: PSOConfig,
    map_cfg: MapConfig,
    radius: int = cost_mod.DEFAULT_STENCIL_RADIUS,
    score_dtype: str = "f32",
    rng_mode: str = "threefry",
    exp_mode=None,
    early_exit: int = 0,
):
    """B whole-solve PSO rollouts, correspondences frozen at the incumbent
    each iteration.  Returns (pose [B, 3], cost [B]).  CPU tensors run the
    plain version; CUDA tensors launch the kernel.

    score_dtype: ``f32`` or ``bf16`` scoring operands (f32 accumulation).
    rng_mode: ``threefry`` (the parity stream) or ``native`` (turbo: Philox).
    exp_mode: ``exp``, ``exp2`` or ``approx``; None takes the rng mode's
    default (``exp`` for Threefry, ``exp2`` for turbo).
    early_exit: stop a solve once its best has stalled this many iterations
    (0 = the fixed budget)."""
    exp_mode = exp_mode or default_exp_mode(rng_mode)
    for name, value, allowed in (("score_dtype", score_dtype, SCORE_DTYPES),
                                 ("rng_mode", rng_mode, RNG_MODES),
                                 ("exp_mode", exp_mode, EXP_MODES)):
        if value not in allowed:
            raise ValueError(f"unknown {name} {value!r}; expected one of {allowed}")
    args = (keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, score_dtype,
            rng_mode, exp_mode, early_exit)
    if sten.device.type == "cpu":
        return pso_rollout_reference(*args)
    if sten.device.type != "cuda":
        raise ValueError(f"unsupported device {sten.device}")
    return _launch(*args)


pso_rollout.LAUNCHES = 0


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
    """B solves in one launch of the whole-solve kernel a ``rollout*`` cost
    mode names: ``rollout_local[_turbo]`` through :func:`pso_rollout_local`,
    ``rollout[_turbo][_bf16]`` through :func:`pso_rollout`.  The stencil is
    gathered at each guess.  Returns (pose [B, 3] f32, cost [B])."""
    if not cost_mode.startswith("rollout"):
        raise ValueError(f"{cost_mode!r} is not a rollout cost mode")
    radius = cost_mod.DEFAULT_STENCIL_RADIUS
    nbrs = cost_mod.bind_neighborhood(guesses, snaps, points, valid, map_cfg, radius)
    rng_mode = "native" if "turbo" in cost_mode else "threefry"
    if "local" in cost_mode:
        sten, pts = pack_rollout_local_inputs(nbrs, points)
        return pso_rollout_local(keys, guesses, deviations, sten, pts, pso_cfg, map_cfg,
                                 radius, early_exit, rng_mode)
    sten, pts = pack_rollout_inputs(nbrs, points)
    return pso_rollout(keys, guesses, deviations, sten, pts, pso_cfg, map_cfg, radius,
                       score_dtype="bf16" if "bf16" in cost_mode else "f32",
                       rng_mode=rng_mode, early_exit=early_exit)
