"""Per-cell 2x2 Gaussian math in closed form.

Port of ``ndtpso_slam_tpu/ops/gaussian.py``.  Symmetric 2x2 matrices are
packed as 3-vectors ``(xx, xy, yy)`` throughout.
"""

from __future__ import annotations

import torch

# Eigenvalue regularization threshold (ndtcell.cpp:103).
EIG_RATIO = 1e-3


def sym2_eigenvalues(cov3: torch.Tensor):
    """Eigenvalues (large, small) of packed symmetric 2x2 matrices [..., 3]."""
    a, b, c = cov3[..., 0], cov3[..., 1], cov3[..., 2]
    half_tr = (a + c) / 2.0
    disc = torch.sqrt(torch.square((a - c) / 2.0) + torch.square(b))
    return half_tr + disc, half_tr - disc


def regularized_inverse(cov3: torch.Tensor) -> torch.Tensor:
    """Regularized inverse of packed symmetric 2x2 covariances
    (``ndtcell.cpp:93-111``).

    If the small eigenvalue is below ``1e-3 * large``, the determinant of the
    adjugate inverse is replaced by ``1e-3 * large^2``; otherwise the true
    determinant is used.  The adjugate itself is never regularized, so a
    covariance with a negative small eigenvalue keeps an indefinite inverse
    (the reference's behaviour, kept for parity), and an all-zero covariance
    gives inf/nan by IEEE division exactly as the C++ does.

    Returns [..., 3] packed inverse (ixx, ixy, iyy)."""
    a, b, c = cov3[..., 0], cov3[..., 1], cov3[..., 2]
    large, small = sym2_eigenvalues(cov3)
    det = torch.where(small < EIG_RATIO * large, EIG_RATIO * large * large, a * c - b * b)
    return torch.stack([c / det, -b / det, a / det], dim=-1)


def quadform(icov3: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """d' Σ⁻¹ d for packed symmetric Σ⁻¹: [..., 3] x [..., 2] -> [...]."""
    dx, dy = d[..., 0], d[..., 1]
    return icov3[..., 0] * dx * dx + 2.0 * icov3[..., 1] * dx * dy + icov3[..., 2] * dy * dy


def ndt_score(d: torch.Tensor, icov3: torch.Tensor, built) -> torch.Tensor:
    """Unnormalized Gaussian score exp(-d'Σ⁻¹d / 2), 0 where not ``built``
    (``NDTCell::normalDistribution``, ``ndtcell.cpp:70-78``)."""
    s = torch.exp(-0.5 * quadform(icov3, d))
    return torch.where(built, s, torch.zeros((), dtype=s.dtype, device=s.device))
