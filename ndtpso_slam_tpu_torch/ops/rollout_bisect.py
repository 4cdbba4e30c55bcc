"""The rollout kernel cut down to one staged kernel: the CUDA kernel
``csrc/rollout_bisect.cu`` and its plain PyTorch version.

Port of ``experiments/rollout_bisect.py:make_kernel(stage)``: K2 reduced
to a radius-2 stencil on a 32 m frame of 1 m cells, Threefry draws, w = 0.8,
c1 = c2 = 2, with its pieces switched on stage by stage (see the note at
the top of the ``.cu`` file, and :data:`STAGES`).  Inputs as the TPU
script packs them: keys [B, 2] u32 words, guesses and deviations [B, 3],
pts [B, 8, N] (px, py, anchor ix, anchor iy, valid, 0, 0, 0), sten
[B, 25, 8, N] (mx, my, la, lb, lc, built, 0, 0); output [B, 8, 128].

:func:`rollout_bisect` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back from
one to the other.  ``rollout_bisect.LAUNCHES`` counts kernel launches.  The
library is built by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ndtpso_slam_tpu_torch.config import MapConfig
from ndtpso_slam_tpu_torch.models.pso import _select_min
from ndtpso_slam_tpu_torch.ops import _build, rng
from ndtpso_slam_tpu_torch.ops.rollout import packed_bind, packed_frozen_cost

P, ITERS, R = 256, 3, 2  # the TPU script's population, iterations, radius
K2 = (2 * R + 1) ** 2
LANES = 128
MAP = MapConfig(size_m=32.0, cell_side_m=1.0)  # the script's frame: |q| < 16, floor(q + 16)
W, C, SEED_AMP = 0.8, 2.0, 0.01
CONST_KEYS = (12345, 67890)
CONST_DEV = 0.2
# Every stage the TPU script defines: 4-9 compute what 3 computes, 13-19
# what 0 computes.
STAGES = tuple(range(28))


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ndt_rollout_bisect.argtypes = [vp] * 6 + [i] * 5 + [vp]
    lib.ndt_rollout_bisect.restype = i
    lib.ndt_bisect_smem_bytes.argtypes = [i]
    lib.ndt_bisect_smem_bytes.restype = ctypes.c_size_t
    lib.ndt_bisect_max_population.argtypes = []
    lib.ndt_bisect_max_population.restype = i


LIB = _build.KernelLib("rollout_bisect", "rollout_bisect.cu", _bind)


def cost_kind(stage: int) -> str:
    """The stage's cost: ``trivial`` -|pos|^2, ``mask_sum`` -(sum of the
    bind's mask + |pos|^2), or ``quad`` the full frozen quadratic form."""
    if stage < 2 or stage >= 10:
        return "trivial"
    return "mask_sum" if stage == 2 else "quad"


def _check(stage, keys, guesses, devs, pts, sten, population, iterations):
    if stage not in STAGES:
        raise ValueError(f"stage {stage} is not one of the script's stages 0-27")
    b, rows, n = pts.shape
    if rows != 8 or tuple(sten.shape) != (b, K2, 8, n):
        raise ValueError(f"bad shapes: pts {tuple(pts.shape)}, sten {tuple(sten.shape)}")
    if tuple(keys.shape) != (b, 2) or tuple(guesses.shape) != (b, 3) or tuple(devs.shape) != (b, 3):
        raise ValueError("keys, guesses and devs must be [B, 2], [B, 3], [B, 3]")
    if pts.dtype not in (torch.float32, torch.float64) or sten.dtype != pts.dtype:
        raise TypeError("pts and sten must be float32 (float64 for the plain version)")
    for name, t in (("keys", keys), ("guesses", guesses), ("devs", devs), ("sten", sten)):
        if t.device != pts.device:
            raise ValueError(f"{name} is on {t.device}, pts on {pts.device}")
    if population < 1 or iterations < 0:
        raise ValueError(f"population {population}, iterations {iterations}")
    return b, n


def _sq3(poses):
    return poses[..., 0] * poses[..., 0] + poses[..., 1] * poses[..., 1] + poses[..., 2] * poses[..., 2]


def rollout_bisect_reference(stage, keys, guesses, devs, pts, sten, population=P,
                             iterations=ITERS):
    """Plain PyTorch version of :func:`rollout_bisect`, in the dtype of pts
    and sten: float32 as the kernel computes, or float64 to see what float32
    rounding moves (the draws are the same; they are exact in float32)."""
    b, n = _check(stage, keys, guesses, devs, pts, sten, population, iterations)
    dt, dev, p = pts.dtype, pts.device, population
    if stage in (10, 12) or stage >= 20:
        k = torch.tensor(CONST_KEYS, dtype=torch.int64, device=dev).expand(b, 2)
    else:
        k = keys.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    if stage in (10, 11) or stage >= 20:
        guess = torch.zeros((b, 3), dtype=dt, device=dev)
        dev3 = torch.full((b, 3), CONST_DEV, dtype=dt, device=dev)
    else:
        guess, dev3 = guesses.to(dt), devs.to(dt)
    kb = (k[:, 0, None, None], k[:, 1, None, None])

    u_g = rng.uniform_pairs((k[:, 0, None], k[:, 1, None]),
                            torch.arange(8, dtype=torch.int64, device=dev))[0].to(dt)  # [B, 8]
    guess8 = torch.cat([guess, torch.zeros((b, 5), dtype=dt, device=dev)], dim=1)
    g8 = guess8 + (2.0 * u_g - 1.0) * SEED_AMP  # the seed, all 8 rows

    def out(rows):  # [B, 8] -> every lane
        return rows[:, :, None].expand(b, 8, LANES).contiguous()

    if stage == 26:
        return out(torch.ones((b, 8), dtype=dt, device=dev))
    if stage == 20:
        return out(g8[:, :, None].expand(b, 8, p).sum(dim=-1))

    kind = cost_kind(stage)
    if kind == "trivial":
        cost_fn = lambda poses, binds: -_sq3(poses)
    elif kind == "mask_sum":
        cost_fn = lambda poses, binds: -(
            packed_bind(binds, sten, pts, MAP, R)[3].sum(dim=-1)[:, None] + _sq3(poses))
    else:
        cost_fn = lambda poses, binds: packed_frozen_cost(poses, binds, sten, pts, MAP, R)

    g_cost = cost_fn(g8[:, None, :3], guess)[:, 0]
    if stage in (21, 24, 25):
        return out((g_cost + 0.0)[:, None].expand(b, 8))
    _, p_ctr = rng.pso_init_pairs(p, dev)
    u_p = rng.uniform_pairs(kb, p_ctr)[0].to(dt)  # [B, P, 3]
    pos = guess[:, None, :] + (2.0 * u_p - 1.0) * dev3[:, None, :]
    cost = cost_fn(pos, guess)
    bc, bp = _select_min(cost, pos)
    if stage == 22:  # rows 3-7 of the population are 0
        return out(torch.cat([bp + bc[:, None], (0.0 + bc)[:, None].expand(b, 5)], dim=1))
    imp = bc < g_cost
    gbest = torch.where(imp[:, None], bp, g8[:, :3])
    gcost = torch.where(imp, bc, g_cost)
    if stage == 23:
        rest = torch.where(imp[:, None], torch.zeros((), dtype=dt, device=dev), g8[:, 3:])
        return out(torch.cat([gbest, rest], dim=1) + gcost[:, None])
    if 1 <= stage < 10:
        vel, pbest, pbc = torch.zeros_like(pos), pos, cost
        for it in range(iterations):
            r1, r2 = (r.to(dt) for r in rng.uniform_pairs(kb, rng.pso_iter_pairs(it, p, dev)))
            vel = W * vel + C * r1 * (pbest - pos) + C * r2 * (gbest[:, None, :] - pos)
            pos = pos + vel
            cost = cost_fn(pos, gbest)
            better = cost < pbc
            pbest = torch.where(better[..., None], pos, pbest)
            pbc = torch.where(better, cost, pbc)
            bci, bpi = _select_min(pbc, pbest)
            gimp = bci < gcost
            gbest = torch.where(gimp[:, None], bpi, gbest)
            gcost = torch.where(gimp, bci, gcost)
    return out(torch.cat([gbest, gcost[:, None].expand(b, 5)], dim=1))


def rollout_bisect(stage: int, keys, guesses, devs, pts, sten, population: int = P,
                   iterations: int = ITERS) -> torch.Tensor:
    """Stage ``stage`` (0-27) of the staged rollout kernel for B solves:
    keys [B, 2] u32 words, guesses and devs [B, 3], pts [B, 8, N], sten
    [B, 25, 8, N]; ``population`` particles, ``iterations`` PSO steps.
    Returns [B, 8, 128]: rows 0-2 the global best, rows 3-7 its cost (the
    early-return stages 20-27 their own rows).  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if pts.device.type == "cpu":
        return rollout_bisect_reference(stage, keys, guesses, devs, pts, sten, population,
                                        iterations)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    b, n = _check(stage, keys, guesses, devs, pts, sten, population, iterations)
    if pts.dtype != torch.float32:
        raise TypeError("the kernel takes float32 pts and sten")
    lib = _build.load(LIB)
    if population > lib.ndt_bisect_max_population():
        raise ValueError(f"population {population} > {lib.ndt_bisect_max_population()}, "
                         "the most one launch takes")
    smem = lib.ndt_bisect_smem_bytes(n)
    limit = torch.cuda.get_device_properties(pts.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"N={n} needs {smem} B of shared memory; the device allows {limit} B")
    dev = pts.device
    pts, sten = pts.contiguous(), sten.contiguous()
    guesses = guesses.to(torch.float32).contiguous()
    devs = devs.to(torch.float32).contiguous()
    k32 = _build.u32_words(keys, dev)
    out = torch.empty((b, 8, LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ndt_rollout_bisect(
            k32.data_ptr(), guesses.data_ptr(), devs.data_ptr(), pts.data_ptr(), sten.data_ptr(),
            out.data_ptr(), b, n, population, iterations, stage,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(lib, err, "rollout_bisect")
    rollout_bisect.LAUNCHES += 1
    return out


rollout_bisect.LAUNCHES = 0
