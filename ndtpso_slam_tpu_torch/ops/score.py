"""Fused frozen-correspondence scoring: the CUDA kernel ``csrc/score.cu`` and
its plain PyTorch version.

Port of ``fused_bound_scores`` / ``_score_kernel`` of
``ndtpso_slam_tpu/ops/pallas_score.py``: for every solve b and particle j,
``cost[b, j] = -Σₙ mask[b, n]·exp(-max(w[b, n]·φᵀ[b, :, j], 0)/2)``.  Any P
and 15 or 16 features: the TPU kernel's padding to 16 features and its
particle-tile divisibility rule are not needed here.  The kernel scores a
register tile of 4 particles per thread (see the note at the top of the
``.cu`` file).

:func:`fused_bound_scores` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back from
one to the other.  ``fused_bound_scores.LAUNCHES`` counts kernel launches.
The library is built by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ndtpso_slam_tpu_torch.ops import _build


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ndt_score.argtypes = [vp] * 4 + [i] * 4 + [vp]
    lib.ndt_score.restype = i
    lib.ndt_score_smem_bytes.argtypes = [i]
    lib.ndt_score_smem_bytes.restype = ctypes.c_size_t


LIB = _build.KernelLib("score", "score.cu", _bind)


def fused_bound_scores_reference(phit: torch.Tensor, w: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch version: z = w·φᵀ [B, N, P], then ``-(mask · s)``."""
    z = w @ phit  # [B, N, P]
    s = torch.exp(-0.5 * torch.clamp(z, min=0.0))
    return -(mask[:, None, :] @ s)[:, 0, :]


def _launch(phit, w, mask):
    dev = phit.device
    b, f, p = phit.shape
    n = w.shape[1]
    if w.device != dev or mask.device != dev:
        raise ValueError(f"phit, w and mask must share a device: {dev}, {w.device}, {mask.device}")
    if w.shape != (b, n, f) or mask.shape != (b, n) or f not in (15, 16):
        raise ValueError(
            f"bad shapes: phit {tuple(phit.shape)}, w {tuple(w.shape)}, mask {tuple(mask.shape)}"
        )
    if {phit.dtype, w.dtype, mask.dtype} != {torch.float32}:
        raise TypeError("phit, w and mask must be float32")
    lib = _build.load(LIB)
    smem = lib.ndt_score_smem_bytes(n)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"N={n} needs {smem} B of shared memory; the device allows {limit} B")
    phit, w, mask = phit.contiguous(), w.contiguous(), mask.contiguous()
    out = torch.empty((b, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_score(
            phit.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n, f, p, stream
        )
    _build.check_launch(lib, err, "score")
    fused_bound_scores.LAUNCHES += 1
    return out


def fused_bound_scores(
    phit: torch.Tensor,  # [B, 15 or 16, P] f32 (features transposed)
    w: torch.Tensor,  # [B, N, 15 or 16] f32
    mask: torch.Tensor,  # [B, N] f32
) -> torch.Tensor:  # [B, P] costs
    """Frozen-correspondence costs of B solves' P particles.  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if phit.device.type == "cpu":
        return fused_bound_scores_reference(phit, w, mask)
    if phit.device.type != "cuda":
        raise ValueError(f"unsupported device {phit.device}")
    return _launch(phit, w, mask)


fused_bound_scores.LAUNCHES = 0
