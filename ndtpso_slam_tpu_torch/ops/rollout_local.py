"""Whole-solve PSO with per-particle exact stencil rebinning: the CUDA kernel
``csrc/rollout_local.cu``, its plain PyTorch version, and the input packer.

Port of ``pack_rollout_local_inputs`` / ``pso_rollout_local`` /
``_rollout_local_kernel`` of ``ndtpso_slam_tpu/ops/pallas_rollout.py``: the
Threefry branch with exact ``exp`` (``rollout_local``) and the turbo branch
(``rng_mode="native"``: Philox draws, ``exp2`` scoring;
``rollout_local_turbo``), both with the early exit.  The kernel runs one
whole solve per thread-block cluster of C CTAs, each CTA scoring its slice
of the points from its slice of the stencil table in shared memory (see the
note at the top of the ``.cu`` file); :func:`smem_bytes` is one CTA's shared
memory and ``_build.choose_cluster`` picks C from it.  Up to
:data:`MAX_POPULATION` particles the state lives in registers; larger
populations take the kernel's global route, the state in a scratch buffer
the wrapper allocates (``pso_rollout_local.LAST_ROUTE``).  The kernel sums each
cost over a CTA's points, then the CTAs' partials in rank order:
:func:`packed_stencil_cost` with ``cluster=C`` is that order in plain
PyTorch.

:func:`pso_rollout_local` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back from
one to the other.  ``pso_rollout_local.LAUNCHES`` counts kernel launches
and ``pso_rollout_local.LAST_CLUSTER`` is the C of the last launch.  The
library is built by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig, ZERO_DEVIATION
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.pso import pso_solve
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops.geometry import cell_coords, transform_points
from ndtpso_slam_tpu_torch.utils import profiling

# Penalty of an unbuilt stencil lane in the packed table (the TPU kernel adds
# it to the quadratic form so the score is exp(-BIG/2) == 0).
BIG = 1e9
# exp(-q/2) == 2^(q * EXP2_SCALE): float32(-0.5 / ln 2), the turbo scoring.
EXP2_SCALE = float(torch.tensor(-0.5 / math.log(2.0), dtype=torch.float32))
EXP_MODES = ("exp", "exp2")
# The register route's most particles (16 per thread of 512,
# csrc/rollout_local.cu: kMaxPPT * kThreads); above it, the global route.
MAX_POPULATION = 16 * 512


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ndt_rollout_local.argtypes = [vp] * 7 + [i] * 9 + [f] * 9 + [vp]
    lib.ndt_rollout_local.restype = i
    lib.ndt_rollout_local_smem_bytes.argtypes = [i, i, i, i]
    lib.ndt_rollout_local_smem_bytes.restype = ctypes.c_size_t
    lib.ndt_rollout_local_slice_floats.argtypes = [i]
    lib.ndt_rollout_local_slice_floats.restype = ctypes.c_size_t
    lib.ndt_rollout_local_max_population.argtypes = []
    lib.ndt_rollout_local_max_population.restype = i
    lib.ndt_rollout_local_max_active_clusters.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.ndt_rollout_local_max_active_clusters.restype = i


LIB = _build.KernelLib("rollout_local", "rollout_local.cu", _bind)


def global_route(population: int) -> bool:
    """Whether a launch keeps the particle state in global scratch."""
    return population > MAX_POPULATION


def smem_bytes(n_pts: int, population: int, cluster: int,
               radius: int = cost_mod.DEFAULT_STENCIL_RADIUS) -> int:
    """Dynamic shared memory of one CTA of the kernel (csrc/rollout_local.cu:
    smem_bytes): its slice of the stencil table [K2, S, 8] (each lane padded
    by 4 floats) and point columns [5, S], S = ceil(N / cluster), and on the
    register route the partial costs [P + 1]."""
    s = -(-n_pts // cluster)
    k2 = (2 * radius + 1) ** 2
    part = 0 if global_route(population) else population + 1
    return 4 * ((k2 * 8 + 5) * s + 4 * k2 + part)


def clusters_held(n_pts: int, population: int, cluster: int, radius: int, device) -> int:
    """The most clusters of ``cluster`` CTAs ``device`` holds at once for the
    kernel at this shape and route (cudaOccupancyMaxActiveClusters; every
    register-route instantiation has 512 threads at <= 128 registers)."""
    return _build.max_active_clusters(_build.load(LIB), "ndt_rollout_local_max_active_clusters",
                                      device, n_pts, population, cluster, radius)


def rank_sliced_sum(s: torch.Tensor, cluster: int) -> torch.Tensor:
    """Sum over the last axis in the order of a cluster of ``cluster`` CTAs:
    CTA r sums its slice [r·S, (r + 1)·S), S = ceil(N / cluster), and the
    partials are added in rank order 0 .. cluster - 1."""
    n = s.shape[-1]
    step = -(-n // cluster)
    total = s[..., 0:step].sum(dim=-1)
    for r in range(1, cluster):
        total = total + s[..., r * step:(r + 1) * step].sum(dim=-1)
    return total


def default_exp_mode(rng_mode: str) -> str:
    """``exp`` for the Threefry parity stream, ``exp2`` for turbo, as in the
    JAX package (pallas_rollout.py:471-472)."""
    return "exp2" if rng_mode == "native" else "exp"


def pack_rollout_local_inputs(nbr: cost_mod.NeighborhoodBind, points: torch.Tensor):
    """Repack a NeighborhoodBind and its points [..., N, 2] into the kernel's
    layouts: stencil [..., K2, N, 8] (per lane: mx, my, la, lb, lc, pen, 0, 0)
    and points [..., N, 8] (px, py, anchor_ix, anchor_iy, valid, 0, 0, 0).

    Statistics of unbuilt lanes are zeroed by a select (they may hold inf or
    NaN inverse covariances) and their penalty is BIG; built lanes have
    penalty 0."""
    f32 = torch.float32
    dev = points.device
    built = nbr.built[..., None]
    zero = torch.zeros((), dtype=f32, device=dev)
    sten = torch.cat(
        [
            torch.where(built, nbr.mean.to(f32), zero),
            torch.where(built, nbr.icov.to(f32), zero),
            torch.where(built, zero, torch.full((), BIG, dtype=f32, device=dev)),
            torch.zeros((*nbr.built.shape, 2), dtype=f32, device=dev),
        ],
        dim=-1,
    ).transpose(-3, -2).contiguous()  # [..., K2, N, 8]
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
        dim=-1,
    )  # [..., N, 8]
    return sten, pts


def packed_stencil_cost(
    poses: torch.Tensor,  # [P, 3]
    sten: torch.Tensor,  # [K2, N, 8]
    pts: torch.Tensor,  # [N, 8]
    map_cfg: MapConfig,
    radius: int,
    exp_mode: str = "exp",
    cluster: int = 1,
) -> torch.Tensor:  # [P]
    """``models/cost.py:stencil_exact_cost`` on the packed inputs: the cost
    the kernel evaluates for every particle, scored with ``exp`` or, in the
    turbo branch, ``exp2``; with ``cluster`` > 1 the points are summed in the
    kernel's order on that many CTAs (:func:`rank_sliced_sum`)."""
    side = 2 * radius + 1
    q = transform_points(pts[:, 0:2], poses)  # [P, N, 2]
    jx, jy, inb = cell_coords(q, size_m=map_cfg.size_m, cell_side_m=map_cfg.cell_side_m)
    di = jx - pts[:, 2].to(torch.int32)[None, :]
    dj = jy - pts[:, 3].to(torch.int32)[None, :]
    in_st = (di.abs() <= radius) & (dj.abs() <= radius)
    kk = torch.where(in_st, (dj + radius) * side + (di + radius), 0).long()
    lane = sten[kk, torch.arange(pts.shape[0], device=pts.device)[None, :]]  # [P, N, 8]
    dx = q[..., 0] - lane[..., 0]
    dy = q[..., 1] - lane[..., 1]
    quad = lane[..., 2] * dx * dx + 2.0 * lane[..., 3] * dx * dy + lane[..., 4] * dy * dy
    ok = in_st & (lane[..., 5] == 0.0) & inb & (pts[:, 4] != 0.0)[None, :]
    s = torch.exp2(quad * EXP2_SCALE) if exp_mode == "exp2" else torch.exp(-0.5 * quad)
    s = torch.where(ok, s, torch.zeros((), dtype=s.dtype, device=s.device))
    if cluster > 1:
        return -rank_sliced_sum(s, cluster)
    return -torch.sum(s, dim=-1)


def pso_rollout_local_reference(
    keys, guesses, deviations, sten, pts, cfg: PSOConfig, map_cfg: MapConfig,
    radius: int = cost_mod.DEFAULT_STENCIL_RADIUS, early_exit: int = 0,
    rng_mode: str = "threefry", exp_mode=None, cluster: int = 1,
):
    """Plain PyTorch version of the kernel: ``pso_solve`` over
    :func:`packed_stencil_cost`, one solve after another, with the draws of
    ``rng_mode`` and the point sums in the order of a cluster of ``cluster``
    CTAs.  Same arguments and results as :func:`pso_rollout_local`."""
    exp_mode = exp_mode or default_exp_mode(rng_mode)
    keys = keys.to(torch.int64).cpu()
    poses, costs = [], []
    for b in range(sten.shape[0]):
        res = pso_solve(
            (int(keys[b, 0]), int(keys[b, 1])),
            guesses[b].to(torch.float32),
            deviations[b].to(torch.float32),
            lambda p, _bind, b=b: packed_stencil_cost(
                p, sten[b], pts[b], map_cfg, radius, exp_mode, cluster
            ),
            cfg,
            early_exit=early_exit,
            rng_mode=rng_mode,
        )
        poses.append(res.pose)
        costs.append(res.cost)
    return torch.stack(poses), torch.stack(costs)


def _launch(keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, early_exit,
            rng_mode, exp_mode, cluster):
    dev = sten.device
    b, k2, n, cols = sten.shape
    for name, t in (("guesses", guesses), ("deviations", deviations), ("pts", pts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, sten on {dev}")
    if sten.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError("sten and pts must be float32")
    if cols != 8 or pts.shape != (b, n, 8) or k2 != (2 * radius + 1) ** 2:
        raise ValueError(f"bad shapes: sten {tuple(sten.shape)}, pts {tuple(pts.shape)}")
    if guesses.shape != (b, 3) or deviations.shape != (b, 3) or keys.shape != (b, 2):
        raise ValueError("keys, guesses and deviations must be [B, 2], [B, 3], [B, 3]")
    lib = _build.load(LIB)
    c = _build.device_cluster(
        ("rollout_local", n, cfg.population, radius), b,
        lambda c: smem_bytes(n, cfg.population, c, radius),
        lambda c: clusters_held(n, cfg.population, c, radius, dev), dev, cluster)
    glob = global_route(cfg.population)
    scratch = (torch.empty((b * c, _build.slice_floats(cfg.population)), dtype=torch.float32,
                           device=dev)
               if glob else None)
    sten = sten.contiguous()
    if sten.data_ptr() % 16:
        raise ValueError("sten must be 16-byte aligned")
    pts = pts.contiguous()
    guesses = guesses.to(torch.float32).contiguous()
    deviations = deviations.to(torch.float32).contiguous()
    keys32 = _build.u32_words(keys, dev)
    out = torch.empty((b, 4), dtype=torch.float32, device=dev)
    zd = ZERO_DEVIATION
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_rollout_local(
            keys32.data_ptr(), guesses.data_ptr(), deviations.data_ptr(),
            sten.data_ptr(), pts.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, n, cfg.population, cfg.iterations, radius, early_exit,
            int(rng_mode == "native"), int(exp_mode == "exp2"), c,
            map_cfg.half_size_m, map_cfg.cell_side_m,
            cfg.w, cfg.c1, cfg.c2, cfg.w_damping, zd[0], zd[1], zd[2],
            stream,
        )
    _build.check_launch(lib, err, "rollout_local")
    pso_rollout_local.LAUNCHES += 1
    pso_rollout_local.LAST_CLUSTER = c
    pso_rollout_local.LAST_ROUTE = "global" if glob else "registers"
    return out[:, 0:3], out[:, 3]


def pso_rollout_local(
    keys: torch.Tensor,  # [B, 2] integer u32 words
    guesses: torch.Tensor,  # [B, 3] f32
    deviations: torch.Tensor,  # [B, 3] f32
    sten: torch.Tensor,  # [B, K2, N, 8] f32 (pack_rollout_local_inputs)
    pts: torch.Tensor,  # [B, N, 8] f32
    cfg: PSOConfig,
    map_cfg: MapConfig,
    radius: int = cost_mod.DEFAULT_STENCIL_RADIUS,
    early_exit: int = 0,
    rng_mode: str = "threefry",
    exp_mode=None,
    cluster=None,
):
    """B whole-solve PSO rollouts with per-particle exact stencil rebinding.
    Returns (pose [B, 3], cost [B]).  CPU tensors run the plain version; CUDA
    tensors launch the kernel.

    rng_mode: ``threefry`` (the parity stream) or ``native`` (turbo: Philox).
    exp_mode: ``exp`` or ``exp2``; None takes the rng mode's default.
    cluster: CTAs per solve; None (every caller but the tests) lets
    ``_build.choose_cluster`` pick it.  A size the device refuses raises.
    On the CPU the plain version sums the points in that cluster's order
    (one pass for None).

    Any population: above :data:`MAX_POPULATION` the kernel keeps the
    particle state in global scratch (``LAST_ROUTE`` "global")."""
    if rng_mode not in ("threefry", "native"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}; expected 'threefry' | 'native'")
    exp_mode = exp_mode or default_exp_mode(rng_mode)
    if exp_mode not in EXP_MODES:
        raise ValueError(f"unknown exp_mode {exp_mode!r}; expected one of {EXP_MODES}")
    if sten.device.type == "cpu":
        return pso_rollout_local_reference(
            keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, early_exit,
            rng_mode, exp_mode, cluster or 1,
        )
    if sten.device.type != "cuda":
        raise ValueError(f"unsupported device {sten.device}")
    with profiling.span("k1.launch"):
        return _launch(keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, early_exit,
                       rng_mode, exp_mode, cluster)


pso_rollout_local.LAUNCHES = 0
pso_rollout_local.LAST_CLUSTER = None
pso_rollout_local.LAST_ROUTE = None
