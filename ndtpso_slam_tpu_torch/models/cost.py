"""NDT registration cost: the exact gather form, its per-particle stencil
twin, and the frozen-correspondence (quadratic-form) form.

Port of ``ndtpso_slam_tpu/models/cost.py``:

* :func:`ndt_cost` — the reference cost (``core.cpp:26-48``): transform,
  bin, gather, score, per pose.
* :func:`bind_neighborhood` — each point's (2r+1)² cell stencil around its
  anchor cell at the solve's initial guess, gathered once per solve.  Only
  the JAX package's ``gather`` strategy is ported; its ``roll`` strategy
  exists because a TPU gathers row by row, and both give the same bits on
  built lanes.  The stencil patch (``MapConfig.stencil_patch_cells``) is a
  mask on that gather: a neighbour outside the patch counts as unbuilt.
* :func:`stencil_exact_cost` — every particle re-bins every point against
  that stencil.  The JAX package selects the stencil lane with a one-hot sum;
  here it is a direct indexed load, which selects the same value (the one-hot
  only ever adds zeros).  Points outside their stencil score 0, the
  reference's convention for points that leave the map.
* The frozen form (``fast*`` modes): :func:`bind_points`,
  :func:`bind_points_matmul` and :func:`bind_points_local` bind every point
  to one cell at a binding pose (the swarm's incumbent) and precompute the
  15 coefficients ``w`` of its quadratic form in
  ``u = [cos dθ - 1, sin dθ, dtx, dty, 1]``; :func:`bound_cost` then scores
  P poses as ``exp(-max(φ(u)·w, 0)/2)`` summed under the mask, and
  :func:`bound_cost_fused` does the same through the fused scoring kernel
  (``ops/score.py``).  The JAX package's one-hot matmul binder and one-hot
  stencil select become plain indexed loads of the same rows.

The binders and scorers take optional leading batch dims: a batch of solves
binds against one snapshot ``[C, ...]`` or one snapshot per solve
``[B, C, ...]``.
"""

from __future__ import annotations

import dataclasses

import torch

from ndtpso_slam_tpu_torch.config import MapConfig
from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
from ndtpso_slam_tpu_torch.ops import gaussian
from ndtpso_slam_tpu_torch.ops.geometry import cell_coords, cell_index, transform_points
from ndtpso_slam_tpu_torch.ops.score import fused_bound_scores

# Default ±cells covered by the stencil binding.
DEFAULT_STENCIL_RADIUS = 2
# Index pairs (a <= b) of the 15 monomials u_a u_b, as in the JAX package.
_IJ = [(a, b) for a in range(5) for b in range(a, 5)]


def _cell_rows(field: torch.Tensor, idx: torch.Tensor, per_solve: bool) -> torch.Tensor:
    """Rows of a per-cell field at cell indices ``idx``: ``field`` is [C, ...]
    (one map) or, with ``per_solve``, [B, C, ...] with ``idx`` [B, ...]."""
    if not per_solve:
        return field[idx]
    b = torch.arange(idx.shape[0], device=idx.device).view(-1, *([1] * (idx.dim() - 1)))
    return field[b, idx]


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
    initial guess): one [N, K2] gather per solve.  Batched: anchor_pose
    [B, 3], points [B, N, 2], valid [B, N], and a snapshot per solve
    ([B, C, ...]) or one shared one.

    A point whose anchor cell is outside the grid has its whole stencil
    unbuilt (``anchor_in``), and so has every neighbour outside the grid;
    those lanes hold the clipped neighbour's statistics, which every consumer
    masks.

    With a stencil patch (0 < ``cfg.stencil_patch_cells`` = ps < the grid's
    side), only the ps x ps cells from origin clip(cell(anchor) - ps//2, 0,
    W - ps) count: a neighbour outside them is unbuilt, the JAX package's
    rule (``cost.py:305-313, 363-380``).  The JAX package cuts the patch out
    of the table to bound a TPU roll's memory traffic; a gather reads only
    the N·K2 rows either way, so here the patch is that mask alone."""
    w_cells = cfg.cells_per_side
    q0 = transform_points(points, anchor_pose)  # [..., N, 2]
    ix, iy, _ = cell_coords(q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    side = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32, device=points.device)
    di, dj = offs.repeat(side), offs.repeat_interleave(side)  # row-major lanes
    nix = ix[..., None] + di  # [..., N, K2]
    niy = iy[..., None] + dj
    in_grid = (nix >= 0) & (nix < w_cells) & (niy >= 0) & (niy < w_cells)
    anchor_in = (ix >= 0) & (ix < w_cells) & (iy >= 0) & (iy < w_cells)
    in_grid = in_grid & anchor_in[..., None]
    ps = cfg.stencil_patch_cells
    if 0 < ps < w_cells:
        ox, oy = window_origin(anchor_pose, ps, cfg)
        ox, oy = ox[..., None, None], oy[..., None, None]
        in_grid = in_grid & (nix >= ox) & (nix < ox + ps) & (niy >= oy) & (niy < oy + ps)
    flat = (
        niy.clamp(0, w_cells - 1).long() * w_cells + nix.clamp(0, w_cells - 1).long()
    )
    per_solve = snap.built.dim() == 2
    return NeighborhoodBind(
        anchor_ix=ix,
        anchor_iy=iy,
        mean=_cell_rows(snap.mean, flat, per_solve),
        icov=_cell_rows(snap.inv_cov, flat, per_solve),
        built=_cell_rows(snap.built, flat, per_solve) & in_grid,
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


@dataclasses.dataclass
class BoundScan:
    """Scan bound to map cells at a binding pose: per-point quadratic-form
    coefficients ``w`` with d'Λd = φ(u)·w, and the score mask."""

    bind_pose: torch.Tensor  # [..., 3]
    w: torch.Tensor  # [..., N, 15]
    mask: torch.Tensor  # [..., N] float (valid & in-bounds & built at binding)


def _quadform_bound(
    bind_pose: torch.Tensor,  # [..., 3]
    points: torch.Tensor,  # [..., N, 2]
    mean: torch.Tensor,  # [..., N, 2] per-point cell mean
    icov: torch.Tensor,  # [..., N, 3] per-point packed Λ
    mask: torch.Tensor,  # [..., N] float
) -> BoundScan:
    """Quadratic-form coefficient build shared by every binder (the math
    below ``core.cpp:37-43``, re-parameterized), in the JAX package's
    operation order.

    With g = R₀p + t₀ - μ, the residual of a pose offset by (dθ, dt) is
    d = B u, u = [cos dθ - 1, sin dθ, dtx, dty, 1]; w holds M = BᵀΛB as
    w_ab = M_ab·(2 - δ_ab) over the pairs a <= b."""
    c0 = torch.cos(bind_pose[..., 2:3])
    s0 = torch.sin(bind_pose[..., 2:3])
    px, py = points[..., 0], points[..., 1]
    rx = px * c0 - py * s0  # R₀p
    ry = px * s0 + py * c0
    gx = rx + bind_pose[..., 0:1] - mean[..., 0]  # g = R₀p + t₀ - μ (small)
    gy = ry + bind_pose[..., 1:2] - mean[..., 1]
    zeros = torch.zeros_like(gx)
    ones = torch.ones_like(gx)
    bx = torch.stack([rx, -ry, ones, zeros, gx], dim=-1)  # [..., N, 5]
    by = torch.stack([ry, rx, zeros, ones, gy], dim=-1)
    la, lb, lc = icov[..., 0:1], icov[..., 1:2], icov[..., 2:3]
    lbx = la * bx + lb * by  # Λ @ B rows
    lby = lb * bx + lc * by
    # Every M_ab = bx_a·lbx_b + by_a·lby_b at once, then the pairs a <= b in
    # _IJ's order: the same roundings as one pair at a time, in a few
    # launches instead of 75.
    m = bx[..., :, None] * lbx[..., None, :] + by[..., :, None] * lby[..., None, :]
    m2 = 2.0 * m
    w = torch.cat([t for a in range(5) for t in (m[..., a, a:a + 1], m2[..., a, a + 1:])],
                  dim=-1)  # [..., N, 15]
    # Zeroing w where masked keeps exp() arguments finite even where Λ was
    # inf/NaN in a degenerate cell.
    w = torch.where(mask[..., None] > 0, w, torch.zeros((), dtype=w.dtype, device=w.device))
    return BoundScan(bind_pose=bind_pose, w=w, mask=mask)


def bind_points(
    bind_pose: torch.Tensor,
    snap: MapSnapshot,
    points: torch.Tensor,
    valid: torch.Tensor,
    cfg: MapConfig,
) -> BoundScan:
    """Bind each point to its map cell at ``bind_pose`` (one gather of N
    rows) and build its quadratic-form coefficients."""
    q0 = transform_points(points, bind_pose)  # [..., N, 2] = R₀p + t₀
    idx, inb = cell_index(
        q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    idx = idx.long()
    per_solve = snap.built.dim() == 2
    mask = (_cell_rows(snap.built, idx, per_solve) & inb & valid).to(points.dtype)
    return _quadform_bound(
        bind_pose, points, _cell_rows(snap.mean, idx, per_solve),
        _cell_rows(snap.inv_cov, idx, per_solve), mask,
    )


def bind_points_matmul(
    bind_pose: torch.Tensor,
    tbl: torch.Tensor,  # [C, 6] or [B, C, 6] from snapshot_table
    points: torch.Tensor,
    valid: torch.Tensor,
    cfg: MapConfig,
) -> BoundScan:
    """The JAX package's one-hot matmul binder (``onehot[N, C] @ tbl``),
    which exists because a TPU gathers row by row.  Each one-hot row selects
    exactly one table row, so here it is that row's gather: the same bits."""
    q0 = transform_points(points, bind_pose)
    idx, inb = cell_index(
        q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    g = _cell_rows(tbl, idx.long(), tbl.dim() == 3)  # [..., N, 6]
    mask = ((g[..., 5] > 0.5) & inb & valid).to(points.dtype)
    return _quadform_bound(bind_pose, points, g[..., 0:2], g[..., 2:5], mask)


def window_origin(pose: torch.Tensor, ps: int, cfg: MapConfig):
    """(ox, oy): the corner cell of the ``ps`` x ``ps`` window centred on
    ``pose``'s cell, clipped so the window lies inside the grid.  pose:
    [..., 3] -> ox, oy [...]."""
    cx, cy, _ = cell_coords(pose[..., :2], size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    hi = cfg.cells_per_side - ps
    return (cx - ps // 2).clamp(0, hi), (cy - ps // 2).clamp(0, hi)


def table_window(tbl: torch.Tensor, origin, ps: int, cfg: MapConfig) -> torch.Tensor:
    """The ``ps`` x ``ps`` window of a [C, 6] table at cell corner
    ``origin`` = (ox, oy), as a [ps·ps, 6] table (row-major, like the grid)."""
    w = cfg.cells_per_side
    ox, oy = origin
    rows = oy + torch.arange(ps, device=tbl.device)
    cols = ox + torch.arange(ps, device=tbl.device)
    return tbl.view(w, w, -1)[rows[:, None], cols[None, :]].reshape(ps * ps, -1)


def bind_points_matmul_window(
    bind_pose: torch.Tensor,
    patch_tbl: torch.Tensor,  # [ps·ps, 6] from table_window
    origin,  # (ox, oy) cell corner of the window
    ps: int,
    points: torch.Tensor,
    valid: torch.Tensor,
    cfg: MapConfig,
) -> BoundScan:
    """:func:`bind_points_matmul` against a ``ps`` x ``ps`` window of the map.
    Points are binned in global cell coordinates and shifted by the window's
    origin, so the rows selected inside it are the full table's; a point
    outside the window (or outside the map) is masked and scores 0, as one
    leaving the map.  The JAX package selects the row with a one-hot matmul
    (a zero row outside the window); here it is a gather of the clipped row,
    and ``_quadform_bound`` zeroes w under the mask, so the result is the
    same and a NaN in a masked lane cannot leak."""
    ox, oy = origin
    q0 = transform_points(points, bind_pose)
    ix, iy, inb = cell_coords(q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    lx = ix - ox
    ly = iy - oy
    in_patch = (lx >= 0) & (lx < ps) & (ly >= 0) & (ly < ps)
    li = torch.where(in_patch, ly * ps + lx, 0).long()
    g = patch_tbl[li]  # [..., N, 6]
    mask = ((g[..., 5] > 0.5) & inb & valid & in_patch).to(points.dtype)
    return _quadform_bound(bind_pose, points, g[..., 0:2], g[..., 2:5], mask)


def bind_points_local(
    bind_pose: torch.Tensor,
    nbr: NeighborhoodBind,
    points: torch.Tensor,
    cfg: MapConfig,
) -> BoundScan:
    """Rebind at ``bind_pose`` against a pre-gathered stencil: each point's
    cell is picked from its stencil by offset arithmetic, as a direct indexed
    load (the JAX package's one-hot sum selects the same value).  A point
    outside its stencil is masked, as one leaving the map."""
    r = nbr.radius
    side = 2 * r + 1
    q0 = transform_points(points, bind_pose)
    jx, jy, inb = cell_coords(q0, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m)
    di = jx - nbr.anchor_ix  # [..., N]
    dj = jy - nbr.anchor_iy
    in_st = (di.abs() <= r) & (dj.abs() <= r)
    k = torch.where(in_st, (dj + r) * side + (di + r), 0).long()[..., None]  # [..., N, 1]
    lane = lambda t: t.gather(-2, k[..., None].expand(*k.shape, t.shape[-1])).squeeze(-2)
    built = nbr.built.gather(-1, k).squeeze(-1) & in_st
    mask = (built & inb & nbr.valid).to(points.dtype)
    return _quadform_bound(bind_pose, points, lane(nbr.mean), lane(nbr.icov), mask)


def _u(poses: torch.Tensor, bind_pose: torch.Tensor, dim: int) -> torch.Tensor:
    """u = [cos dθ - 1, sin dθ, dtx, dty, 1] of poses [..., P, 3] relative
    to bind_pose [..., 3], stacked along ``dim``."""
    dtheta = poses[..., 2] - bind_pose[..., None, 2]
    return torch.stack(
        [
            torch.cos(dtheta) - 1.0,
            torch.sin(dtheta),
            poses[..., 0] - bind_pose[..., None, 0],
            poses[..., 1] - bind_pose[..., None, 1],
            torch.ones_like(dtheta),
        ],
        dim=dim,
    )


def pose_features(poses: torch.Tensor, bind_pose: torch.Tensor) -> torch.Tensor:
    """φ(u) monomials u_a·u_b (a <= b): poses [..., P, 3] relative to
    bind_pose [..., 3] -> [..., P, 15]."""
    u = _u(poses, bind_pose, -1)
    uu = u[..., :, None] * u[..., None, :]  # [..., P, 5, 5]
    return torch.cat([uu[..., a, a:] for a in range(5)], dim=-1)  # pairs in _IJ's order


def pose_features_t(poses: torch.Tensor, bind_pose: torch.Tensor) -> torch.Tensor:
    """φ(u) monomials, feature-major: [..., P, 3] -> [..., 15, P] (the fused
    scoring kernel's operand)."""
    u = _u(poses, bind_pose, -2)
    uu = u[..., :, None, :] * u[..., None, :, :]  # [..., 5, 5, P]
    return torch.cat([uu[..., a, a:, :] for a in range(5)], dim=-2)  # pairs in _IJ's order


def bound_cost(poses: torch.Tensor, bound: BoundScan) -> torch.Tensor:
    """Score poses [..., P, 3] against a bound scan: z = φ·wᵀ, then
    ``-Σ mask·exp(-max(z, 0)/2)``.  Returns [..., P].

    The clamp at 0: regularized inverses of near-degenerate cells can carry a
    numerically negative eigenvalue, harmless in the exact cost but explosive
    when a far-flung particle extrapolates the frozen quadratic."""
    z = pose_features(poses, bound.bind_pose) @ bound.w.transpose(-1, -2)  # [..., P, N]
    score = torch.exp(-0.5 * torch.clamp(z, min=0.0))
    return -(score @ bound.mask[..., None])[..., 0]


def bound_cost_fused(poses: torch.Tensor, bound: BoundScan) -> torch.Tensor:
    """Batched frozen cost, poses [B, P, 3] against a batched bound scan
    (bind_pose [B, 3], w [B, N, 15], mask [B, N]) -> [B, P].  CUDA tensors
    go through the fused scoring kernel (``ops/score.py``), whose [P, N]
    scores never reach device memory; CPU tensors run :func:`bound_cost`."""
    if poses.device.type == "cpu":
        return bound_cost(poses, bound)
    return fused_bound_scores(pose_features_t(poses, bound.bind_pose), bound.w, bound.mask)
