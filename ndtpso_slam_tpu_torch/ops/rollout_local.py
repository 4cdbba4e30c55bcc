"""Whole-solve PSO with per-particle exact stencil rebinning: the CUDA kernel
``csrc/rollout_local.cu``, its plain PyTorch version, and the input packer.

Port of ``pack_rollout_local_inputs`` / ``pso_rollout_local`` /
``_rollout_local_kernel`` of ``ndtpso_slam_tpu/ops/pallas_rollout.py``, in
its Threefry, exact-``exp`` form with the early exit.  The kernel runs one
whole solve per thread block (see the note at the top of the ``.cu`` file).

:func:`pso_rollout_local` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back from
one to the other.  ``pso_rollout_local.LAUNCHES`` counts kernel launches.

The kernel is compiled with ``nvcc`` into a shared library with a plain C
interface at first use, into ``ndtpso_slam_tpu_torch/_build/`` keyed by a
hash of the source and flags, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, PSOConfig, ZERO_DEVIATION
from ndtpso_slam_tpu_torch.models import cost as cost_mod
from ndtpso_slam_tpu_torch.models.pso import pso_solve
from ndtpso_slam_tpu_torch.ops.geometry import cell_coords, transform_points

# Penalty of an unbuilt stencil lane in the packed table (the TPU kernel adds
# it to the quadratic form so the score is exp(-BIG/2) == 0).
BIG = 1e9
_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rollout_local.cu"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math (approximate expf/sinf/cosf) and no FMA contraction, so
# the kernel rounds every + - * / as the plain version does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def pack_rollout_local_inputs(nbr: cost_mod.NeighborhoodBind, points: torch.Tensor):
    """Repack a NeighborhoodBind and its points [N, 2] into the kernel's
    layouts: stencil [K2, N, 8] (per lane: mx, my, la, lb, lc, pen, 0, 0) and
    points [N, 8] (px, py, anchor_ix, anchor_iy, valid, 0, 0, 0).

    Statistics of unbuilt lanes are zeroed by a select (they may hold inf or
    NaN inverse covariances) and their penalty is BIG; built lanes have
    penalty 0."""
    f32 = torch.float32
    n, k2 = nbr.mean.shape[:2]
    built = nbr.built[..., None]
    zero = torch.zeros((), dtype=f32, device=points.device)
    sten = torch.cat(
        [
            torch.where(built, nbr.mean.to(f32), zero),
            torch.where(built, nbr.icov.to(f32), zero),
            torch.where(built, zero, torch.tensor(BIG, dtype=f32, device=points.device)),
            torch.zeros((n, k2, 2), dtype=f32, device=points.device),
        ],
        dim=-1,
    ).transpose(0, 1).contiguous()  # [K2, N, 8]
    pts = torch.stack(
        [
            points[:, 0].to(f32),
            points[:, 1].to(f32),
            nbr.anchor_ix.to(f32),
            nbr.anchor_iy.to(f32),
            nbr.valid.to(f32),
        ]
        + [torch.zeros(n, dtype=f32, device=points.device)] * 3,
        dim=-1,
    )  # [N, 8]
    return sten, pts


def packed_stencil_cost(
    poses: torch.Tensor,  # [P, 3]
    sten: torch.Tensor,  # [K2, N, 8]
    pts: torch.Tensor,  # [N, 8]
    map_cfg: MapConfig,
    radius: int,
) -> torch.Tensor:  # [P]
    """``models/cost.py:stencil_exact_cost`` on the packed inputs: the cost
    the kernel evaluates for every particle."""
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
    s = torch.exp(-0.5 * quad)
    s = torch.where(ok, s, torch.zeros((), dtype=s.dtype, device=s.device))
    return -torch.sum(s, dim=-1)


def pso_rollout_local_reference(
    keys, guesses, deviations, sten, pts, cfg: PSOConfig, map_cfg: MapConfig,
    radius: int = cost_mod.DEFAULT_STENCIL_RADIUS, early_exit: int = 0,
):
    """Plain PyTorch version of the kernel: ``pso_solve`` over
    :func:`packed_stencil_cost`, one solve after another.  Same arguments and
    results as :func:`pso_rollout_local`."""
    keys = keys.to(torch.int64).cpu()
    poses, costs = [], []
    for b in range(sten.shape[0]):
        res = pso_solve(
            (int(keys[b, 0]), int(keys[b, 1])),
            guesses[b].to(torch.float32),
            deviations[b].to(torch.float32),
            lambda p, _bind, b=b: packed_stencil_cost(p, sten[b], pts[b], map_cfg, radius),
            cfg,
            early_exit=early_exit,
        )
        poses.append(res.pose)
        costs.append(res.cost)
    return torch.stack(poses), torch.stack(costs)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")
    return str(path)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"rollout_local-{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ndt_rollout_local.argtypes = [vp] * 6 + [i] * 6 + [f] * 9 + [vp]
    lib.ndt_rollout_local.restype = i
    lib.ndt_rollout_local_smem_bytes.argtypes = [i, i]
    lib.ndt_rollout_local_smem_bytes.restype = ctypes.c_size_t
    lib.ndt_cuda_error_string.argtypes = [i]
    lib.ndt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build the kernel library now (it is otherwise built at first launch);
    returns its path."""
    return Path(_library()._name)


def _launch(keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, early_exit):
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
    lib = _library()
    smem = lib.ndt_rollout_local_smem_bytes(n, cfg.population)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"N={n}, population={cfg.population} needs {smem} B of shared memory; "
            f"the device allows {limit} B per block"
        )
    sten = sten.contiguous()
    if sten.data_ptr() % 16:
        raise ValueError("sten must be 16-byte aligned")
    pts = pts.contiguous()
    guesses = guesses.to(torch.float32).contiguous()
    deviations = deviations.to(torch.float32).contiguous()
    # u32 key words carried as their int32 bit patterns.
    keys32 = (keys.to(dev).to(torch.int64) & 0xFFFFFFFF).to(torch.int32).contiguous()
    out = torch.empty((b, 4), dtype=torch.float32, device=dev)
    zd = ZERO_DEVIATION
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_rollout_local(
            keys32.data_ptr(), guesses.data_ptr(), deviations.data_ptr(),
            sten.data_ptr(), pts.data_ptr(), out.data_ptr(),
            b, n, cfg.population, cfg.iterations, radius, early_exit,
            map_cfg.half_size_m, map_cfg.cell_side_m,
            cfg.w, cfg.c1, cfg.c2, cfg.w_damping, zd[0], zd[1], zd[2],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"rollout_local kernel launch failed: {lib.ndt_cuda_error_string(err).decode()}"
        )
    pso_rollout_local.LAUNCHES += 1
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
):
    """B whole-solve PSO rollouts with per-particle exact stencil rebinding.
    Returns (pose [B, 3], cost [B]).  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if sten.device.type == "cpu":
        return pso_rollout_local_reference(
            keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, early_exit
        )
    if sten.device.type != "cuda":
        raise ValueError(f"unsupported device {sten.device}")
    return _launch(keys, guesses, deviations, sten, pts, cfg, map_cfg, radius, early_exit)


pso_rollout_local.LAUNCHES = 0
