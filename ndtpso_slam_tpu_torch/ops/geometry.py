"""SE(2) / polar geometry primitives on tensors with leading batch dims.

Port of ``ndtpso_slam_tpu/ops/geometry.py`` (reference ``core.h:28-47``),
with the same operation order so float32 results match bit for bit where the
elementary functions agree.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# Floored cell coordinates are clamped to this magnitude before the int32
# cast: a float far outside int32 range has no defined conversion, and any
# coordinate this large is outside every grid and every stencil anyway.
_COORD_CLAMP = float(1 << 30)


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Rigid SE(2) transform: points [..., N, 2] by pose [..., 3] (the pose's
    batch dims broadcast against the points' dims excluding N)."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    px, py = points[..., 0], points[..., 1]
    x = px * c - py * s + pose[..., 0][..., None]
    y = px * s + py * c + pose[..., 1][..., None]
    return torch.stack([x, y], dim=-1)


def index_to_angle(idx: torch.Tensor, step, min_angle) -> torch.Tensor:
    """Beam index -> bearing angle (reference ``core.h:40-42``)."""
    return idx * step + min_angle


@functools.lru_cache(maxsize=64)
def bearing_table(angle_min: float, angle_increment: float, n: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """[n, 2] (cos θ, sin θ) of the beams' bearings θ_i = i·increment + min,
    made once per scan geometry on the host and kept on ``device``.

    θ is rounded to ``dtype`` as :func:`index_to_angle` rounds it (the scan
    metadata first, then one product and one sum).  Its cos and sin are the
    host libm's double values rounded to ``dtype``, so they are the correctly
    rounded values on every device.  PyTorch's float32 ``cos``/``sin`` are
    one ulp off on 25 and 29 of the 384 bearings of the golden test's log
    (XLA's on 9 and 5), and one ulp of a beam can put a point across a cell
    border: a cell built on one side and not the other (ROADMAP §3, F2)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    theta = np.arange(n, dtype=np_dtype) * np_dtype.type(angle_increment) + np_dtype.type(angle_min)
    table = np.array([(math.cos(t), math.sin(t)) for t in theta.astype(np.float64).tolist()],
                     dtype=np_dtype).reshape(n, 2)
    return torch.from_numpy(table).to(device)


def polar_to_point(r: torch.Tensor, bearings: torch.Tensor) -> torch.Tensor:
    """Polar -> cartesian (reference ``laser_to_point``, ``core.h:45-47``):
    ranges [..., N] times the bearings' (cos, sin) [N, 2]."""
    return r[..., None] * bearings


def origin_at(points: torch.Tensor, cell_side: float) -> torch.Tensor:
    """Snap points to their cell origin (reference ``core.h:33-36``)."""
    return torch.floor(points / cell_side) * cell_side


def _floor_i32(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v).clamp(-_COORD_CLAMP, _COORD_CLAMP).to(torch.int32)


def cell_coords(points: torch.Tensor, *, size_m: float, cell_side_m: float):
    """(column, row) cell coordinates and the strict-border in-bounds mask
    (``NDTFrame::getCellIndex``, ``ndtframe.cpp:240-249``): a point is in
    bounds only strictly inside the frame borders.

    Returns (ix [...] int32, iy [...] int32, in_bounds [...] bool)."""
    half = size_m / 2.0
    x, y = points[..., 0], points[..., 1]
    inb = (x > -half) & (x < half) & (y > -half) & (y < half)
    ix = _floor_i32((x + half) / cell_side_m)
    iy = _floor_i32((y + half) / cell_side_m)
    return ix, iy, inb


def cell_index(
    points: torch.Tensor, *, size_m: float, cell_side_m: float, cells_per_side: int
):
    """Linear cell index ``ix + W * iy`` clipped to the grid (safe to gather
    with; mask with ``in_bounds``) and the strict-border in-bounds mask."""
    ix, iy, inb = cell_coords(points, size_m=size_m, cell_side_m=cell_side_m)
    idx = ix + cells_per_side * iy
    idx = idx.clamp(0, cells_per_side * cells_per_side - 1)
    return idx, inb


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two SE(2) poses: result = a ∘ b (apply b, then a)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + b[..., 0] * c - b[..., 1] * s
    y = a[..., 1] + b[..., 0] * s + b[..., 1] * c
    return torch.stack([x, y, a[..., 2] + b[..., 2]], dim=-1)


def se2_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of an SE(2) pose."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(a[..., 0] * c + a[..., 1] * s)
    y = a[..., 0] * s - a[..., 1] * c
    return torch.stack([x, y, -a[..., 2]], dim=-1)
