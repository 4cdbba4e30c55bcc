"""NDT registration cost: the exact gather form and its per-particle stencil
twin.

Port of the parts of ``ndtpso_slam_tpu/models/cost.py`` that the sequential
SLAM path runs:

* :func:`ndt_cost` — the reference cost (``core.cpp:26-48``): transform,
  bin, gather, score, per pose.
* :func:`bind_neighborhood` — each point's (2r+1)² cell stencil around its
  anchor cell at the solve's initial guess, gathered once per solve.  Only
  the JAX package's ``gather`` strategy is ported; its ``roll`` strategy
  exists because a TPU gathers row by row, and both give the same bits on
  built lanes.
* :func:`stencil_exact_cost` — every particle re-bins every point against
  that stencil.  The JAX package selects the stencil lane with a one-hot sum;
  here it is a direct indexed load, which selects the same value (the one-hot
  only ever adds zeros).  Points outside their stencil score 0, the
  reference's convention for points that leave the map.
"""

from __future__ import annotations

import dataclasses

import torch

from ndtpso_slam_tpu_torch.config import MapConfig
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.ops import gaussian
from ndtpso_slam_tpu_torch.ops.geometry import cell_coords, cell_index, transform_points

# Default ±cells covered by the stencil binding.
DEFAULT_STENCIL_RADIUS = 2


def ndt_cost(
    pose: torch.Tensor,
    snap: MapSnapshot,
    points: torch.Tensor,
    valid: torch.Tensor,
    cfg: MapConfig,
) -> torch.Tensor:
    """Exact reference cost (``core.cpp:26-48``).

    pose: [..., 3]; points: [N, 2]; valid: [N].  Returns [...]."""
    q = transform_points(points, pose)  # [..., N, 2]
    idx, inb = cell_index(
        q, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    idx = idx.long()
    score = gaussian.ndt_score(
        q - snap.mean[idx], snap.inv_cov[idx], snap.built[idx] & inb & valid
    )
    return -torch.sum(score, dim=-1)


def snapshot_table(snap: MapSnapshot, dtype=torch.float32) -> torch.Tensor:
    """Pack a snapshot into one [C, 6] table (mean, icov, built)."""
    return torch.cat(
        [snap.mean.to(dtype), snap.inv_cov.to(dtype), snap.built.to(dtype)[:, None]],
        dim=-1,
    )


@dataclasses.dataclass
class NeighborhoodBind:
    """Per-point stencil of map cells around an anchor pose."""

    anchor_ix: torch.Tensor  # [N] int32 column of the anchor cell
    anchor_iy: torch.Tensor  # [N] int32 row
    mean: torch.Tensor  # [N, K2, 2]
    icov: torch.Tensor  # [N, K2, 3]
    built: torch.Tensor  # [N, K2] bool (cell built AND neighbour inside grid)
    valid: torch.Tensor  # [N] bool
    radius: int = DEFAULT_STENCIL_RADIUS


def bind_neighborhood(
    anchor_pose: torch.Tensor,
    snap: MapSnapshot,
    points: torch.Tensor,
    valid: torch.Tensor,
    cfg: MapConfig,
    radius: int = DEFAULT_STENCIL_RADIUS,
) -> NeighborhoodBind:
    """Gather each point's (2r+1)² cell stencil at the anchor pose (the PSO
    initial guess): one [N, K2] gather per solve.

    A point whose anchor cell is outside the grid has its whole stencil
    unbuilt (``anchor_in``), and so has every neighbour outside the grid;
    those lanes hold the clipped neighbour's statistics, which every consumer
    masks."""
    if 0 < cfg.stencil_patch_cells < cfg.cells_per_side:
        raise NotImplementedError(
            "the stencil patch (MapConfig.stencil_patch_cells) belongs to the "
            "JAX package's roll strategy, which is not ported (ROADMAP A6); "
            "the port binds by direct gather"
        )
    w_cells = cfg.cells_per_side
    q0 = transform_points(points, anchor_pose)  # [N, 2]
    ix, iy, _ = cell_coords(q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    side = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32, device=points.device)
    di, dj = offs.repeat(side), offs.repeat_interleave(side)  # row-major lanes
    nix = ix[:, None] + di[None, :]  # [N, K2]
    niy = iy[:, None] + dj[None, :]
    in_grid = (nix >= 0) & (nix < w_cells) & (niy >= 0) & (niy < w_cells)
    anchor_in = (ix >= 0) & (ix < w_cells) & (iy >= 0) & (iy < w_cells)
    in_grid = in_grid & anchor_in[:, None]
    flat = (
        niy.clamp(0, w_cells - 1).long() * w_cells + nix.clamp(0, w_cells - 1).long()
    )
    return NeighborhoodBind(
        anchor_ix=ix,
        anchor_iy=iy,
        mean=snap.mean[flat],
        icov=snap.inv_cov[flat],
        built=snap.built[flat] & in_grid,
        valid=valid,
        radius=radius,
    )


def stencil_exact_cost(
    poses: torch.Tensor,  # [P, 3]
    nbr: NeighborhoodBind,
    points: torch.Tensor,  # [N, 2]
    cfg: MapConfig,
) -> torch.Tensor:  # [P]
    """Exact per-particle correspondence against the pre-gathered stencil:
    equal to :func:`ndt_cost` whenever each point stays within ±radius cells
    of its anchor; beyond that it scores 0."""
    r = nbr.radius
    side = 2 * r + 1
    q = transform_points(points, poses)  # [P, N, 2]
    jx, jy, inb = cell_coords(q, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    di = jx - nbr.anchor_ix[None, :]  # [P, N]
    dj = jy - nbr.anchor_iy[None, :]
    in_st = (di.abs() <= r) & (dj.abs() <= r)
    k = torch.where(in_st, (dj + r) * side + (di + r), 0).long()
    n_idx = torch.arange(points.shape[0], device=points.device)[None, :]
    built = nbr.built[n_idx, k] & in_st
    score = gaussian.ndt_score(
        q - nbr.mean[n_idx, k], nbr.icov[n_idx, k], built & inb & nbr.valid[None, :]
    )
    return -torch.sum(score, dim=-1)
