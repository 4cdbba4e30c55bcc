"""Dense NDT grid map state and its ingestion/build transforms.

Port of ``ndtpso_slam_tpu/models/ndt_map.py``: the map is a set of dense
tensors over the flattened cell grid, every stored moment is centred on its
cell's centre (float32 keeps the ~1e-2 m² cell variance 150 m from the
origin), and the 100-slot sliding window of the reference
(``ndtcell.cpp:21-68``) is a ring of per-slot partial sums.

Two differences from the JAX package, both about memory:

* **In place.**  :func:`add_points`, :func:`build_touched` and :func:`build`
  update the state's tensors in place and return the same object.  The dense
  ring is ~0.86 GB at the 300 m / 0.5 m / 100-slot deployment scale; a
  functional update would copy it every scan.
* **A spare row.**  Every per-cell tensor has ``num_cells + 1`` rows.  Row
  ``num_cells`` is never read: scatters send their dropped entries there,
  which is what the JAX package's ``mode="drop"`` does, without filtering the
  indices (a host sync) and without ever touching a real cell.
  :func:`snapshot` and ``utils/state.py`` see only the real rows.

Scatter-add order: on the CPU ``index_add_`` adds in index order, like XLA's
scatter on the CPU, so the port's statistics match the JAX package bit for
bit there (``tests/test_torch_map.py``).  On CUDA ``index_add_`` of floats
uses atomics, so the open-slot sums of a cell that several beams of one scan
hit can differ in their last bits from run to run; the card is held to the
trajectory gate, not to bit equality.
"""

from __future__ import annotations

import dataclasses

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, resolve_device
from ndtpso_slam_tpu_torch.ops import gaussian
from ndtpso_slam_tpu_torch.ops.geometry import cell_index


@dataclasses.dataclass
class MapSnapshot:
    """What a scan-match solve consumes: built per-cell Gaussians."""

    mean: torch.Tensor  # [C, 2] world-frame cell means
    inv_cov: torch.Tensor  # [C, 3] packed symmetric inverse covariances
    built: torch.Tensor  # [C] bool


@dataclasses.dataclass
class NdtMapState:
    """Accumulator state of the sliding-window NDT map.  Field names and
    meanings are the JAX package's; per-cell tensors carry one spare row."""

    mean_c: torch.Tensor  # [C+1, 2] centred means
    inv_cov: torch.Tensor  # [C+1, 3]
    built: torch.Tensor  # [C+1] bool
    created: torch.Tensor  # [C+1] bool
    g_sum: torch.Tensor  # [C+1, 2] window-global sums
    g_count: torch.Tensor  # [C+1] int32
    g_cov: torch.Tensor  # [C+1, 3]
    slot_sum: torch.Tensor  # [C+1, S, 2] ring of per-slot partials
    slot_count: torch.Tensor  # [C+1, S] int32
    slot_cov: torch.Tensor  # [C+1, S, 3]
    slot_idx: torch.Tensor  # [C+1] int32 current window slot
    ring_map: torch.Tensor  # [0]: dense ring only
    ring_used: torch.Tensor  # [] int32, always 0 (dense ring)
    ring_overflow: torch.Tensor  # [] int32, always 0 (dense ring)
    rot_count: torch.Tensor  # [C+1] int32 cumulative ring rotations
    cur_sum: torch.Tensor  # [C+1, 2] open-slot accumulators
    cur_count: torch.Tensor  # [C+1] int32
    cur_m2: torch.Tensor  # [C+1, 3]


def init_map(cfg: MapConfig, dtype=torch.float32, device="cuda") -> NdtMapState:
    """Fresh all-zero map (NDTFrame ctor, ``ndtframe.cpp:19-66``)."""
    if cfg.ring_rows > 0:
        raise NotImplementedError(
            "sparse ring storage (MapConfig.ring_rows > 0) is not ported yet "
            "(ROADMAP A5); use the dense ring (ring_rows=0)"
        )
    dev = resolve_device(device)
    r = cfg.num_cells + 1
    s = cfg.window_slots
    f = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    i = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    b = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)
    return NdtMapState(
        mean_c=f(r, 2), inv_cov=f(r, 3), built=b(r), created=b(r),
        g_sum=f(r, 2), g_count=i(r), g_cov=f(r, 3),
        slot_sum=f(r, s, 2), slot_count=i(r, s), slot_cov=f(r, s, 3),
        slot_idx=i(r),
        ring_map=i(0), ring_used=i(), ring_overflow=i(),
        rot_count=i(r),
        cur_sum=f(r, 2), cur_count=i(r), cur_m2=f(r, 3),
    )


def _centers_of(cfg: MapConfig, idx: torch.Tensor, dtype) -> torch.Tensor:
    """World coordinates of the centres of cells ``idx``, [..., 2]."""
    w = cfg.cells_per_side
    ix = (idx % w).to(dtype)
    iy = torch.div(idx, w, rounding_mode="floor").to(dtype)
    side = cfg.cell_side_m
    half = cfg.half_size_m
    return torch.stack([(ix + 0.5) * side - half, (iy + 0.5) * side - half], dim=-1)


def cell_centers(cfg: MapConfig, dtype=torch.float32, device="cuda", idx=None) -> torch.Tensor:
    """World coordinates of each cell's centre, [C, 2], or of cells ``idx``
    [..., 2] (the same values, without the whole grid's)."""
    if idx is None:
        idx = torch.arange(cfg.num_cells, dtype=torch.int32, device=resolve_device(device))
    return _centers_of(cfg, idx, dtype)


def add_points(
    state: NdtMapState, cfg: MapConfig, points: torch.Tensor, valid: torch.Tensor
) -> NdtMapState:
    """Scatter world-frame points [N, 2] (mask [N]) into their cells, in place
    (``NDTFrame::addPoint`` -> ``NDTCell::addPoint``, ``ndtframe.cpp:215-225``,
    ``ndtcell.cpp:21-34``): out-of-frame points are dropped, touched cells
    are marked created and un-built."""
    idx, inb = cell_index(
        points, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    mask = valid & inb
    sidx = torch.where(mask, idx, cfg.num_cells).long()  # spare row = drop
    dtype = state.cur_sum.dtype
    centred = (points - _centers_of(cfg, idx, dtype)).to(dtype)
    px, py = centred[..., 0], centred[..., 1]
    m2 = torch.stack([px * px, px * py, py * py], dim=-1)
    state.cur_sum.index_add_(0, sidx, centred)
    state.cur_count.index_add_(0, sidx, mask.to(torch.int32))
    state.cur_m2.index_add_(0, sidx, m2)
    # index_fill_ takes the value as a scalar: an indexed assignment of a
    # Python bool would copy it to the device and wait for the stream.
    state.created.index_fill_(0, sidx, True)
    state.built.index_fill_(0, sidx, False)
    return state


@dataclasses.dataclass
class _CellRows:
    """A gathered batch of per-cell state rows (build scratch)."""

    mean_c: torch.Tensor
    inv_cov: torch.Tensor
    built: torch.Tensor
    g_sum: torch.Tensor
    g_count: torch.Tensor
    g_cov: torch.Tensor
    old_sum: torch.Tensor  # current window slot's stored partials
    old_count: torch.Tensor
    old_cov: torch.Tensor
    slot_idx: torch.Tensor
    rot_count: torch.Tensor
    cur_sum: torch.Tensor
    cur_count: torch.Tensor
    cur_m2: torch.Tensor


def _build_rows(cfg: MapConfig, rows: _CellRows) -> _CellRows:
    """Per-cell sliding-window build (``NDTCell::build``, ``ndtcell.cpp:36-68``),
    in reference order, on a gathered row batch:

      1. WINDOW_ADD of the open slot's sum/count into the window globals;
      2. where the window count exceeds 2: new mean, the open slot's
         covariance contribution around it (from its running second moment),
         WINDOW_ADD of that, refreshed regularized inverse, mark built;
      3. where the open slot holds more than ``slot_capacity`` points: rotate
         the ring and zero the open accumulators.
    """
    dtype = rows.cur_sum.dtype
    g_sum = rows.g_sum + rows.cur_sum - rows.old_sum
    g_count = rows.g_count + rows.cur_count - rows.old_count
    has_stats = g_count > 2
    hs = has_stats[:, None]
    n_w = torch.clamp(g_count, min=1).to(dtype)
    mean_c_new = g_sum / n_w[:, None]
    n_cur = rows.cur_count.to(dtype)
    sx, sy = rows.cur_sum[:, 0], rows.cur_sum[:, 1]
    mx, my = mean_c_new[:, 0], mean_c_new[:, 1]
    cov_cur = torch.stack(
        [
            rows.cur_m2[:, 0] - 2.0 * mx * sx + n_cur * mx * mx,
            rows.cur_m2[:, 1] - mx * sy - my * sx + n_cur * mx * my,
            rows.cur_m2[:, 2] - 2.0 * my * sy + n_cur * my * my,
        ],
        dim=-1,
    )
    g_cov_new = rows.g_cov + cov_cur - rows.old_cov
    covar = g_cov_new / n_w[:, None]
    inv_cov_new = gaussian.regularized_inverse(covar)
    rotate = rows.cur_count > cfg.slot_capacity
    rot = rotate[:, None]
    zero_f = torch.zeros((), dtype=dtype, device=rows.cur_sum.device)
    return _CellRows(
        mean_c=torch.where(hs, mean_c_new, rows.mean_c),
        inv_cov=torch.where(hs, inv_cov_new, rows.inv_cov),
        built=rows.built | has_stats,
        g_sum=g_sum,
        g_count=g_count,
        g_cov=torch.where(hs, g_cov_new, rows.g_cov),
        old_sum=rows.cur_sum,  # new slot contents
        old_count=rows.cur_count,
        old_cov=torch.where(hs, cov_cur, rows.old_cov),
        slot_idx=torch.where(
            rotate, (rows.slot_idx + 1) % cfg.window_slots, rows.slot_idx
        ),
        rot_count=rows.rot_count + rotate.to(torch.int32),
        cur_sum=torch.where(rot, zero_f, rows.cur_sum),
        cur_count=torch.where(rotate, 0, rows.cur_count),
        cur_m2=torch.where(rot, zero_f, rows.cur_m2),
    )


def build_touched(
    state: NdtMapState, cfg: MapConfig, ids: torch.Tensor
) -> NdtMapState:
    """Build only the cells in ``ids``, in place.

    ids: [M] flat cell ids; entries >= ``cfg.num_cells`` are dropped.
    Duplicates are fine: duplicate rows compute identical values.  As in the
    JAX package, this equals the dense :func:`build` provided a build ran
    after every prior ingestion and a cell whose build rotated its ring is
    rebuilt on the next build (``slam_step`` passes this scan's ids and the
    previous scan's)."""
    c = cfg.num_cells
    ids = ids.long()
    sentinel = ids >= c
    safe = torch.where(sentinel, 0, ids)
    sidx = torch.where(sentinel, c, ids)
    slot = state.slot_idx[safe].long()
    rows = _CellRows(
        mean_c=state.mean_c[safe],
        inv_cov=state.inv_cov[safe],
        built=state.built[safe],
        g_sum=state.g_sum[safe],
        g_count=state.g_count[safe],
        g_cov=state.g_cov[safe],
        old_sum=state.slot_sum[safe, slot],
        old_count=state.slot_count[safe, slot],
        old_cov=state.slot_cov[safe, slot],
        slot_idx=state.slot_idx[safe],
        rot_count=state.rot_count[safe],
        cur_sum=state.cur_sum[safe],
        cur_count=state.cur_count[safe],
        cur_m2=state.cur_m2[safe],
    )
    new = _build_rows(cfg, rows)
    state.mean_c[sidx] = new.mean_c
    state.inv_cov[sidx] = new.inv_cov
    state.built[sidx] = new.built
    state.g_sum[sidx] = new.g_sum
    state.g_count[sidx] = new.g_count
    state.g_cov[sidx] = new.g_cov
    # The slot write targets the pre-rotation slot, as the dense pass does.
    state.slot_sum[sidx, slot] = new.old_sum
    state.slot_count[sidx, slot] = new.old_count
    state.slot_cov[sidx, slot] = new.old_cov
    state.slot_idx[sidx] = new.slot_idx
    state.rot_count[sidx] = new.rot_count
    state.cur_sum[sidx] = new.cur_sum
    state.cur_count[sidx] = new.cur_count
    state.cur_m2[sidx] = new.cur_m2
    return state


def build(state: NdtMapState, cfg: MapConfig) -> NdtMapState:
    """Dense build of every cell, in place (``NDTFrame::build``,
    ``ndtframe.cpp:68-117``): the per-cell math of :func:`build_touched`
    over all cells."""
    ids = torch.arange(cfg.num_cells, device=state.slot_idx.device)
    return build_touched(state, cfg, ids)


def snapshot(state: NdtMapState, cfg: MapConfig) -> MapSnapshot:
    """World-frame Gaussians of the real cells, for solving."""
    c = cfg.num_cells
    centers = cell_centers(cfg, state.mean_c.dtype, state.mean_c.device)
    return MapSnapshot(
        mean=centers + state.mean_c[:c], inv_cov=state.inv_cov[:c],
        built=state.built[:c],
    )


def smooth_snapshot(snap: MapSnapshot, sigma: float) -> MapSnapshot:
    """Covariance-inflated snapshot for coarse-to-fine matching: every cell's
    Σ' = Σ + σ²I, recomputed from the packed inverse in closed 2x2 form
    (Σ = adj(Λ)/det(Λ)), in the JAX package's operation order.  A cell whose
    inverse has det <= 1e-20 is marked unbuilt, so the wide basins come only
    from cells with a usable Gaussian."""
    a, b, c = snap.inv_cov[..., 0], snap.inv_cov[..., 1], snap.inv_cov[..., 2]
    det = a * c - b * b  # det of Λ = 1/det(Σ)
    ok = det > 1e-20
    safe = torch.where(ok, det, torch.ones((), dtype=det.dtype, device=det.device))
    s2 = torch.tensor(sigma * sigma, dtype=snap.inv_cov.dtype).item()
    ca = c / safe + s2
    cb = -b / safe
    cc = a / safe + s2
    d2 = ca * cc - cb * cb
    icov = torch.stack([cc / d2, -cb / d2, ca / d2], dim=-1)
    return MapSnapshot(mean=snap.mean, inv_cov=icov, built=snap.built & ok)
