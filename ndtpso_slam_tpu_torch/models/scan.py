"""Laser-scan ingestion: fixed-shape padded point sets with validity masks.

Port of ``ndtpso_slam_tpu/models/scan.py`` (``NDTFrame::loadLaser``,
``ndtframe.cpp:144-185``): per-beam range filtering, polar -> cartesian
conversion, the optional sensor-mount transform, and the frame clip.  Scans
are padded to ``max_beams`` and carry a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ndtpso_slam_tpu_torch.config import MapConfig, ScanConfig, resolve_device
from ndtpso_slam_tpu_torch.ops.geometry import (
    bearing_table,
    index_to_angle,
    polar_to_point,
    transform_points,
)


@dataclasses.dataclass
class Scan:
    points: torch.Tensor  # [N, 2] cartesian points in the base frame
    valid: torch.Tensor  # [N] bool


def _frontal_keep_mask(theta: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``PREFER_FRONTAL_POINTS`` beam decimation (``ndtframe.cpp:157-182``).

    Walk the beams in order, accumulating ``Δθ += cos(θ)`` over valid beams
    only; a beam is kept when the accumulated |Δθ| exceeds 0.5, which resets
    the accumulator.  A sequential threshold-accumulator, so a plain loop on
    the host in float32 (the reference's ``float delta_theta``)."""
    c = torch.cos(theta).cpu().numpy()
    v = valid.cpu().numpy()
    keep = np.zeros(v.shape, bool)
    delta = np.float32(0.0)
    half = np.float32(0.5)
    for i in range(v.shape[-1]):
        if not v[i]:
            continue
        delta = np.float32(delta + c[i])
        if abs(delta) > half:
            keep[i] = True
            delta = np.float32(0.0)
    return torch.from_numpy(keep).to(valid.device)


def load_laser(
    ranges,
    angle_min,
    angle_increment,
    range_max,
    cfg: ScanConfig,
    map_cfg: Optional[MapConfig] = None,
    mount=None,
    dtype=torch.float32,
    device="cuda",
) -> Scan:
    """Convert raw ranges [N] (zero-padded, zero is always invalid) to a masked
    cartesian point set padded to ``cfg.max_beams``.

    map_cfg: if given, points outside the frame borders are invalidated
    (``ndtframe.cpp:220-223``).  mount: optional [3] base<-scan transform
    applied at load (``ndtframe.cpp:174-177``)."""
    dev = resolve_device(device)
    ranges = torch.as_tensor(ranges, dtype=dtype).to(dev)
    n = ranges.shape[-1]
    if n > cfg.max_beams:
        raise ValueError(f"scan has {n} beams > max_beams={cfg.max_beams}")
    if n < cfg.max_beams:
        ranges = torch.nn.functional.pad(ranges, (0, cfg.max_beams - n))
    valid = (ranges > 0.0) & (ranges < range_max) & (ranges > cfg.ignore_epsilon)
    if cfg.prefer_frontal_points:
        # The scan metadata is rounded to the working dtype first, as the
        # reference engine does with jnp.asarray(angle_*, dtype).
        theta = index_to_angle(torch.arange(cfg.max_beams, dtype=dtype, device=dev),
                               torch.tensor(angle_increment, dtype=dtype, device=dev),
                               torch.tensor(angle_min, dtype=dtype, device=dev))
        valid = valid & _frontal_keep_mask(theta, valid)
    bearings = bearing_table(float(angle_min), float(angle_increment), cfg.max_beams, dtype,
                             ranges.device)
    points = polar_to_point(ranges, bearings)
    if mount is not None:
        mount_t = torch.as_tensor(np.asarray(mount), dtype=dtype)
        if bool((mount_t.abs() > 1e-6).any()):
            points = transform_points(points, mount_t.to(dev))
    if map_cfg is not None:
        half = map_cfg.half_size_m
        x, y = points[..., 0], points[..., 1]
        valid = valid & (x > -half) & (x < half) & (y > -half) & (y < half)
    return Scan(points=points, valid=valid)
