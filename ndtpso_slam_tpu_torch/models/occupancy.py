"""Occupancy-grid raster: dense Gaussian sampling of built NDT cells.

Port of ``ndtpso_slam_tpu/models/occupancy.py`` (the sub-map occupancy grid
the reference fills during ``NDTFrame::build``, ``ndtframe.cpp:69-112``):
every built NDT cell's Gaussian is sampled at the centres of its finer
occupancy sub-cells and stored as ``int8(p * 100)``.

The reference's quirks are kept: ``p * 100`` is truncated to int8 (as XLA
converts: toward zero, saturating, NaN to 0), a built parent whose sampled
probability is below 0.01 overwrites its sub-cell with 0, sub-cells beyond
``cells_per_side * per_cell`` are never written, and the bounding box is
monotone and counts only sub-cells written with p > 0 -- where XLA flushes a
subnormal p to 0, so p > 0 reads p >= the smallest normal float.

Two differences from the JAX package, as in ``models/ndt_map.py``:

* **In place.**  Both updates write into the grid's raster and return a
  grid that shares it (the raster is 9 MB at the 300 m / 0.1 m deployment
  scale).
* **A spare slot.**  The raster is the first H·W entries of a flat
  [H·W + 1] buffer; the incremental update sends the sub-cells it skips to
  slot H·W, which is never read, instead of filtering its indices.  With the
  bounding box kept as 0-d device tensors, the update adds no host
  synchronization to the SLAM step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, OccupancyGridConfig, resolve_device
from ndtpso_slam_tpu_torch.models import ndt_map
from ndtpso_slam_tpu_torch.ops import gaussian

# The empty bounding box's bounds (2**30, as in the JAX package).
BIG = 2**30


def _positive(p: torch.Tensor) -> torch.Tensor:
    """p > 0 as XLA reads it, subnormals flushed to 0."""
    return p >= torch.finfo(p.dtype).tiny


@dataclasses.dataclass
class OccupancyGrid:
    og: torch.Tensor  # [H, W] int8, p*100 per sub-cell: a view of buf[:H*W]
    buf: torch.Tensor  # [H*W + 1] int8; slot H*W takes the skipped writes
    # Monotone bounding box of ever-written sub-cells, [] int32 each.
    min_x: torch.Tensor
    max_x: torch.Tensor
    min_y: torch.Tensor
    max_y: torch.Tensor


def og_dims(map_cfg: MapConfig, og_cfg: OccupancyGridConfig):
    """(rows, cols, og_cells_per_ndt_cell), ``ndtframe.cpp:40-42,70``."""
    n = int(math.ceil(map_cfg.size_m / og_cfg.cell_size_m))
    per_cell = int(math.floor(map_cfg.cell_side_m / og_cfg.cell_size_m))
    return n, n, per_cell


def grid_from_raster(og: torch.Tensor, min_x, max_x, min_y, max_y) -> OccupancyGrid:
    """A grid holding a copy of raster ``og`` [H, W] and the given bounds."""
    h, w = og.shape
    buf = torch.zeros(h * w + 1, dtype=torch.int8, device=og.device)
    buf[: h * w] = og.reshape(-1)
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32, device=og.device)
    return OccupancyGrid(og=buf[: h * w].view(h, w), buf=buf, min_x=i32(min_x),
                         max_x=i32(max_x), min_y=i32(min_y), max_y=i32(max_y))


def init_og(map_cfg: MapConfig, og_cfg: OccupancyGridConfig, device="cuda") -> OccupancyGrid:
    """An all-zero raster with the empty bounding box, on ``device``."""
    h, w, _ = og_dims(map_cfg, og_cfg)
    og = torch.zeros((h, w), dtype=torch.int8, device=resolve_device(device))
    return grid_from_raster(og, BIG, -BIG, BIG, -BIG)


def _to_int8(p: torch.Tensor) -> torch.Tensor:
    """``(p * 100).astype(int8)`` as XLA converts: toward zero, saturating
    at the int8 range, NaN to 0 (a plain ``.to(torch.int8)`` wraps)."""
    x = torch.nan_to_num(p * 100.0, nan=0.0, posinf=127.0, neginf=-128.0)
    return torch.clamp(x, -128.0, 127.0).to(torch.int8)


def _centers(oxy, map_cfg: MapConfig, og_cfg: OccupancyGridConfig, dtype):
    """World coordinates of the centres of sub-cells oxy [..., 2] (column,
    row), ``ndtframe.cpp:85-89``."""
    cs = torch.tensor(og_cfg.cell_size_m, dtype=dtype)
    off = float(cs / 2)  # exact: the halved float32 cell size
    return oxy.to(dtype) * float(cs) + off - map_cfg.half_size_m


def _bbox(og: OccupancyGrid, wrote, oxy):
    """The grid's bounds widened by the sub-cells of oxy [..., 2] that
    ``wrote`` [...] marks."""
    xy = oxy.movedim(-1, 0).to(torch.int32).flatten(1)  # [2, n]
    wrote = wrote.flatten()
    lo = torch.where(wrote, xy, BIG).amin(dim=1)
    hi = torch.where(wrote, xy, -BIG).amax(dim=1)
    return dict(min_x=torch.minimum(og.min_x, lo[0]), max_x=torch.maximum(og.max_x, hi[0]),
                min_y=torch.minimum(og.min_y, lo[1]), max_y=torch.maximum(og.max_y, hi[1]))


def og_update(
    og: OccupancyGrid,
    state: ndt_map.NdtMapState,
    map_cfg: MapConfig,
    og_cfg: OccupancyGridConfig,
) -> OccupancyGrid:
    """Refresh the raster from the current built cells (one dense pass)."""
    h, w, per_cell = og_dims(map_cfg, og_cfg)
    dtype = state.mean_c.dtype
    dev = state.mean_c.device
    wc = map_cfg.cells_per_side
    rows, cols = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=dev),
                                torch.arange(w, dtype=torch.int32, device=dev), indexing="ij")
    oxy = torch.stack([cols, rows], dim=-1)  # [h, w, 2]
    # Sub-cells generated by the reference's loops: ox = cell_x*per_cell + j,
    # j < per_cell; anything beyond wc*per_cell is untouched.
    covered = (oxy < wc * per_cell).all(dim=-1)
    cell = torch.clamp(oxy // per_cell, max=wc - 1)
    parent = (cell[..., 0] + wc * cell[..., 1]).long()  # [h, w]
    built = state.built[parent] & covered
    mean = ndt_map.cell_centers(map_cfg, dtype, dev, parent) + state.mean_c[parent]
    p = gaussian.ndt_score(_centers(oxy, map_cfg, og_cfg, dtype) - mean,
                           state.inv_cov[parent], built)
    og.og.copy_(torch.where(built, _to_int8(p), og.og))
    return dataclasses.replace(og, **_bbox(og, built & _positive(p), oxy))


def og_update_incremental(
    og: OccupancyGrid,
    state: ndt_map.NdtMapState,
    map_cfg: MapConfig,
    og_cfg: OccupancyGridConfig,
    cell_ids: torch.Tensor,  # [M] parent cells touched this scan (out of range: skip)
) -> OccupancyGrid:
    """Refresh only the sub-cell blocks of the given parent NDT cells, at
    O(M · per_cell²) sub-cells instead of the whole raster.

    Equal to :func:`og_update` after a scan whose changed cells are all in
    ``cell_ids`` (a cell's Gaussian only changes when it is rebuilt).  The
    SLAM step passes this scan's ids, as the JAX step does, although it
    rebuilds last scan's cells too (ROADMAP R1).  Duplicate ids write
    bit-identical values, so the scatter is deterministic on CUDA too."""
    h, w, per_cell = og_dims(map_cfg, og_cfg)
    dtype = state.mean_c.dtype
    dev = state.mean_c.device
    wc = map_cfg.cells_per_side
    ids = cell_ids.to(device=dev, dtype=torch.int32)
    in_range = (ids >= 0) & (ids < map_cfg.num_cells)
    safe = torch.where(in_range, ids, 0).long()
    built = state.built[safe] & in_range  # [M]

    k = torch.arange(per_cell * per_cell, device=dev)
    sub = torch.stack([k % per_cell, k // per_cell], dim=-1)  # [K, 2] offsets in a cell
    cell = torch.stack([safe % wc, safe // wc], dim=-1)  # [M, 2]
    oxy = cell[:, None, :] * per_cell + sub[None]  # [M, K, 2] sub-cell column, row

    mean = (ndt_map.cell_centers(map_cfg, dtype, dev, safe) + state.mean_c[safe])[:, None, :]
    p = gaussian.ndt_score(_centers(oxy, map_cfg, og_cfg, dtype) - mean,
                           state.inv_cov[safe][:, None, :], built[:, None])  # [M, K]
    flat = oxy[..., 1] * w + oxy[..., 0]
    sidx = torch.where(built[:, None], flat, h * w)  # skipped -> spare slot
    og.buf.scatter_(0, sidx.reshape(-1), _to_int8(p).reshape(-1))
    return dataclasses.replace(og, **_bbox(og, built[:, None] & _positive(p), oxy))
