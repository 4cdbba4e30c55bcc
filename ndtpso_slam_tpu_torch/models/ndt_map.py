"""Dense NDT grid map state and its ingestion/build transforms.

Port of ``ndtpso_slam_tpu/models/ndt_map.py``: the map is a set of dense
tensors over the flattened cell grid, every stored moment is centred on its
cell's centre (float32 keeps the ~1e-2 m² cell variance 150 m from the
origin), and the 100-slot sliding window of the reference
(``ndtcell.cpp:21-68``) is a ring of per-slot partial sums.

The ring is dense (``MapConfig.ring_rows`` 0: one ring row per cell) or
sparse (``ring_rows`` = R > 0: R rows, each given to a cell on its first
build through ``ring_map``; see :func:`build_touched`).  The dense ring is
~0.86 GB at the 300 m / 0.5 m / 100-slot deployment scale, a sparse one of
16,384 rows ~39 MB.

Two differences from the JAX package, both about memory:

* **In place.**  :func:`add_points`, :func:`build_touched` and :func:`build`
  update the state's tensors in place and return the same object; a
  functional update would copy the ring every scan.
* **A spare row.**  Every per-cell tensor has ``num_cells + 1`` rows, and
  the ring's slot tensors have one row more than the ring (``num_cells + 1``
  dense, ``ring_rows + 1`` sparse).  The last row is never read: scatters
  send their dropped entries there, which is what the JAX package's
  ``mode="drop"`` does, without filtering the indices (a host sync) and
  without ever touching a real cell.  :func:`snapshot` and
  ``utils/state.py`` see only the real rows.

A stack of B maps (the fleet's, ``parallel/fleet.py``) has the same fields
with a leading [B]; :func:`add_points_stacked` and
:func:`build_touched_stacked` update it through the flat [B·(C+1), ...]
views, and :func:`add_points` and :func:`build_touched` are their one-map
case.

Scatter-add order: on the CPU ``index_add_`` adds in index order, like XLA's
scatter on the CPU, so the port's statistics match the JAX package bit for
bit there (``tests/test_torch_map.py``).  On CUDA ``index_add_`` of floats
uses atomics, so the open-slot sums of a cell that several beams of one scan
hit can differ in their last bits from run to run, unless
``torch.use_deterministic_algorithms`` is on (``chip_smoke.py`` compares
runs bit for bit that way); otherwise the card is held to the trajectory
gate, not to bit equality.  The step's update, :func:`ingest_scan`, takes
one kernel on CUDA with a dense ring (``ops/ndt_ingest.py``) that adds in
index order, so the solo step's map is the same on every run; the fleet and
the sparse ring still take the PyTorch ops.
"""

from __future__ import annotations

import dataclasses

import torch

from ndtpso_slam_tpu_torch.config import MapConfig, resolve_device
from ndtpso_slam_tpu_torch.ops import gaussian
from ndtpso_slam_tpu_torch.ops.geometry import cell_index, transform_points
from ndtpso_slam_tpu_torch.ops.ndt_ingest import ndt_ingest


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
    slot_sum: torch.Tensor  # [C+1 | R+1, S, 2] ring of per-slot partials
    slot_count: torch.Tensor  # [C+1 | R+1, S] int32
    slot_cov: torch.Tensor  # [C+1 | R+1, S, 3]
    slot_idx: torch.Tensor  # [C+1] int32 current window slot
    # Sparse ring only: cell -> ring row (-1 never built, -2 overflowed: no
    # row was left at its first build, and it never builds).  [0] dense.
    ring_map: torch.Tensor  # [C+1] int32 | [0]
    ring_used: torch.Tensor  # [] int32 rows given out
    ring_overflow: torch.Tensor  # [] int32 distinct cells that found no row
    rot_count: torch.Tensor  # [C+1] int32 cumulative ring rotations
    cur_sum: torch.Tensor  # [C+1, 2] open-slot accumulators
    cur_count: torch.Tensor  # [C+1] int32
    cur_m2: torch.Tensor  # [C+1, 3]


def init_map(cfg: MapConfig, dtype=torch.float32, device="cuda") -> NdtMapState:
    """Fresh all-zero map (NDTFrame ctor, ``ndtframe.cpp:19-66``); a sparse
    ring's ``ring_map`` starts at -1 (no cell has a row)."""
    dev = resolve_device(device)
    r = cfg.num_cells + 1
    sparse = cfg.ring_rows > 0
    rr = cfg.ring_rows + 1 if sparse else r
    s = cfg.window_slots
    f = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    i = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    b = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)
    return NdtMapState(
        mean_c=f(r, 2), inv_cov=f(r, 3), built=b(r), created=b(r),
        g_sum=f(r, 2), g_count=i(r), g_cov=f(r, 3),
        slot_sum=f(rr, s, 2), slot_count=i(rr, s), slot_cov=f(rr, s, 3),
        slot_idx=i(r),
        ring_map=torch.full((r if sparse else 0,), -1, dtype=torch.int32, device=dev),
        ring_used=i(), ring_overflow=i(),
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


def _stacked(state: NdtMapState) -> NdtMapState:
    """A solo map as a stack of one: [None] views of its tensors."""
    return NdtMapState(**{f.name: getattr(state, f.name)[None] for f in dataclasses.fields(state)})


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, M, ...] -> [B·M, ...], a view of the contiguous stack."""
    return x.view((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _bases(b: int, stride: int, device):
    """Robot b's first flat row, b·stride, as [B, 1]; None for one map (its
    flat ids are its own)."""
    return None if b == 1 else torch.arange(b, device=device)[:, None] * stride


def _at(x, base):
    return x if base is None else x + base


def add_points(
    state: NdtMapState, cfg: MapConfig, points: torch.Tensor, valid: torch.Tensor
) -> NdtMapState:
    """Scatter world-frame points [N, 2] (mask [N]) into their cells, in place
    (``NDTFrame::addPoint`` -> ``NDTCell::addPoint``, ``ndtframe.cpp:215-225``,
    ``ndtcell.cpp:21-34``): out-of-frame points are dropped, touched cells
    are marked created and un-built.  The one-map case of
    :func:`add_points_stacked`."""
    add_points_stacked(_stacked(state), cfg, points[None], valid[None])
    return state


def add_points_stacked(
    state: NdtMapState, cfg: MapConfig, points: torch.Tensor, valid: torch.Tensor
) -> NdtMapState:
    """:func:`add_points` for a stack of B maps (fields [B, C+1, ...]), in
    place, as one update per field over the flat [B·(C+1), ...] views: map
    b's cell id becomes b·(C+1) + id, and its dropped points go to its own
    spare row.  points: [B, N, 2]; valid: [B, N]."""
    c = cfg.num_cells
    idx, inb = cell_index(
        points, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m,
        cells_per_side=cfg.cells_per_side,
    )
    mask = valid & inb
    sidx = torch.where(mask, idx, c).long()  # spare row = drop
    sidx = _at(sidx, _bases(sidx.shape[0], c + 1, sidx.device)).reshape(-1)
    dtype = state.cur_sum.dtype
    centred = (points - _centers_of(cfg, idx, dtype)).to(dtype)
    px, py = centred[..., 0], centred[..., 1]
    m2 = torch.stack([px * px, px * py, py * py], dim=-1)
    _flat(state.cur_sum).index_add_(0, sidx, centred.reshape(-1, 2))
    _flat(state.cur_count).index_add_(0, sidx, mask.reshape(-1).to(torch.int32))
    _flat(state.cur_m2).index_add_(0, sidx, m2.reshape(-1, 3))
    # index_fill_ takes the value as a scalar: an indexed assignment of a
    # Python bool would copy it to the device and wait for the stream.
    _flat(state.created).index_fill_(0, sidx, True)
    _flat(state.built).index_fill_(0, sidx, False)
    return state


def update(
    state: NdtMapState, cfg: MapConfig, pose: torch.Tensor, points: torch.Tensor,
    valid: torch.Tensor,
) -> NdtMapState:
    """Transform a scan [N, 2] by ``pose`` [3] and ingest it, in place
    (``NDTFrame::update``, ``ndtframe.cpp:187-198``)."""
    return add_points(state, cfg, transform_points(points, pose), valid)


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


def _assign_ring_rows(state: NdtMapState, cfg: MapConfig, sidx: torch.Tensor) -> None:
    """Give each distinct cell of the flat ids ``sidx`` of a stack of B maps
    (map b's ids offset by b·(C+1), its sentinel its spare row) that has
    never been built a ring row of its own map, in place: rows
    ``ring_used[b]``, ``ring_used[b]`` + 1, ... in ascending cell order, as
    the JAX package's cumsum over its [C] mark assigns them
    (``ndt_map.py:388-420``; per robot, ``parallel/fleet.py:118-148``).  A
    new cell past row R is marked -2 and counted once in ``ring_overflow``.
    The JAX package marks and sums over all C cells; here the ids are sorted
    and the first of each run of equal ids stands for its cell, which
    touches O(M log M) entries instead of O(C) and gives the same rows.  The
    sorted ids run map by map, so the count of new cells restarts at each
    map's segment."""
    c, rows = cfg.num_cells, cfg.num_cells + 1
    b = state.ring_used.shape[0]
    srt = torch.sort(sidx).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    robot = torch.div(srt, rows, rounding_mode="floor")
    ring_map = _flat(state.ring_map)
    new = first & (srt - robot * rows < c) & (ring_map[srt] == -1)
    n_new = new.to(torch.int32)
    per_robot = torch.zeros(b, dtype=torch.int32, device=srt.device).index_add_(0, robot, n_new)
    before = torch.cumsum(per_robot, 0, dtype=torch.int32) - per_robot  # earlier maps' new cells
    assigned = (state.ring_used[robot] + torch.cumsum(n_new, 0, dtype=torch.int32)
                - before[robot] - 1)
    ok = new & (assigned < cfg.ring_rows)
    # new marks distinct cells, so only spare rows are written twice.
    ring_map[torch.where(new, srt, robot * rows + c)] = torch.where(ok, assigned, -2)
    state.ring_used.index_add_(0, robot, ok.to(torch.int32))
    state.ring_overflow.index_add_(0, robot, (new & ~ok).to(torch.int32))


def _index_put(fields, idx: torch.Tensor, vals) -> None:
    """``field[idx] = val`` for each field."""
    for f, v in zip(fields, vals):
        f[idx] = v


def build_touched(
    state: NdtMapState, cfg: MapConfig, ids: torch.Tensor
) -> NdtMapState:
    """Build only the cells in ``ids``, in place.

    ids: [M] flat cell ids; entries >= ``cfg.num_cells`` are dropped.
    Duplicates are fine: duplicate rows compute identical values.  As in the
    JAX package, this equals the dense :func:`build` provided a build ran
    after every prior ingestion and a cell whose build rotated its ring is
    rebuilt on the next build (``slam_step`` passes this scan's ids and the
    previous scan's).

    Sparse ring: a cell gets its ring row at its first build
    (:func:`_assign_ring_rows`); a cell without one (overflowed) is left out
    of every write, so it never builds and scores as outside the map.  The
    one-map case of :func:`build_touched_stacked`."""
    build_touched_stacked(_stacked(state), cfg, ids[None])
    return state


def build_touched_stacked(
    state: NdtMapState, cfg: MapConfig, ids: torch.Tensor, put_rows=_index_put
) -> NdtMapState:
    """:func:`build_touched` for a stack of B maps (fields [B, C+1, ...], a
    sparse ring's slots [B, R+1, S, ...], ``ring_used`` [B]), in place, as
    gathers and writes over the flat views: map b's cell id becomes
    b·(C+1) + id (its ring row b·(R+1) + row), and its dropped ids go to its
    own spare rows.  Per map the same ``_build_rows`` math on the same rows
    as a build of that map alone.

    ids: [B, M] map-local cell ids (>= C dropped).  ``put_rows(fields, idx,
    vals)`` writes the float fields of one width on one id stream,
    ``{mean_c, g_sum, cur_sum}`` and ``{inv_cov, g_cov, cur_m2}`` (indexed
    assignment unless the caller gives another writer); the other fields
    take indexed assignment."""
    c = cfg.num_cells
    b, dev = ids.shape[0], ids.device
    cells = _bases(b, c + 1, dev)
    ids = ids.long()
    sentinel = ids >= c
    safe = _at(torch.where(sentinel, 0, ids), cells)
    sidx = _at(torch.where(sentinel, c, ids), cells)
    if cfg.ring_rows > 0:
        r = cfg.ring_rows
        ring = _bases(b, r + 1, dev)
        _assign_ring_rows(state, cfg, sidx.reshape(-1))
        rrow = _flat(state.ring_map)[safe].long()  # map-local ring rows
        has_row = rrow >= 0
        sidx = torch.where(has_row, sidx, _at(c, cells))
        ring_idx = _at(torch.where(has_row & ~sentinel, rrow, r), ring)
        ring_safe = _at(torch.where(has_row, rrow, 0), ring)
    else:
        ring_idx, ring_safe = sidx, safe
    safe, sidx, ring_idx, ring_safe = (x.reshape(-1) for x in (safe, sidx, ring_idx, ring_safe))
    f = {name: _flat(getattr(state, name)) for name in (
        "mean_c", "inv_cov", "built", "g_sum", "g_count", "g_cov", "slot_sum", "slot_count",
        "slot_cov", "slot_idx", "rot_count", "cur_sum", "cur_count", "cur_m2")}
    slot = f["slot_idx"][safe].long()
    new = _build_rows(cfg, _CellRows(
        mean_c=f["mean_c"][safe],
        inv_cov=f["inv_cov"][safe],
        built=f["built"][safe],
        g_sum=f["g_sum"][safe],
        g_count=f["g_count"][safe],
        g_cov=f["g_cov"][safe],
        old_sum=f["slot_sum"][ring_safe, slot],
        old_count=f["slot_count"][ring_safe, slot],
        old_cov=f["slot_cov"][ring_safe, slot],
        slot_idx=f["slot_idx"][safe],
        rot_count=f["rot_count"][safe],
        cur_sum=f["cur_sum"][safe],
        cur_count=f["cur_count"][safe],
        cur_m2=f["cur_m2"][safe],
    ))
    put_rows([f["mean_c"], f["g_sum"], f["cur_sum"]], sidx, [new.mean_c, new.g_sum, new.cur_sum])
    put_rows([f["inv_cov"], f["g_cov"], f["cur_m2"]], sidx,
             [new.inv_cov, new.g_cov, new.cur_m2])
    for name in ("built", "g_count", "slot_idx", "rot_count", "cur_count"):
        f[name][sidx] = getattr(new, name)
    # The slot write targets the pre-rotation slot, as the dense pass does.
    f["slot_sum"][ring_idx, slot] = new.old_sum
    f["slot_count"][ring_idx, slot] = new.old_count
    f["slot_cov"][ring_idx, slot] = new.old_cov
    return state


def ingest_scan(
    state: NdtMapState, cfg: MapConfig, pose: torch.Tensor, points: torch.Tensor,
    valid: torch.Tensor, prev_ids: torch.Tensor,
) -> torch.Tensor:
    """A scan step's map update, in place: the scan ``points`` [N, 2] (mask
    ``valid`` [N]) transformed by ``pose`` [3] and added to the map, then
    the cells it touched and those of ``prev_ids`` [N] (the previous scan's
    ids) built.  Returns the scan's cell ids [N] int32, ``num_cells`` where
    a beam was dropped (invalid or out of frame).

    On a CUDA device with a dense ring, one launch of
    ``ops/ndt_ingest.py``'s kernel (which raises on more beams than its
    ``MAX_BEAMS``); elsewhere the PyTorch ops of
    :func:`ingest_scan_reference`.  The kernel adds in index order, so its
    map equals theirs on the CPU, and on CUDA under deterministic
    algorithms, in every real row (the spare row aside)."""
    if points.is_cuda and cfg.ring_rows == 0:
        return ndt_ingest(state, cfg, pose, points, valid, prev_ids)
    return ingest_scan_reference(state, cfg, pose, points, valid, prev_ids)


def ingest_scan_reference(
    state: NdtMapState, cfg: MapConfig, pose: torch.Tensor, points: torch.Tensor,
    valid: torch.Tensor, prev_ids: torch.Tensor,
) -> torch.Tensor:
    """:func:`ingest_scan` in PyTorch ops, on any device and ring."""
    wpts = transform_points(points, pose)
    idx, inb = cell_index(
        wpts, size_m=cfg.size_m, cell_side_m=cfg.cell_side_m, cells_per_side=cfg.cells_per_side,
    )
    ids = torch.where(valid & inb, idx, cfg.num_cells).to(torch.int32)
    add_points(state, cfg, wpts, valid)
    # A scan changes only the cells it binned into, plus last scan's cells
    # (post-rotation slot eviction): build exactly those.
    build_touched(state, cfg, torch.cat([ids, prev_ids]))
    return ids


def build(state: NdtMapState, cfg: MapConfig) -> NdtMapState:
    """Dense build of every cell, in place (``NDTFrame::build``,
    ``ndtframe.cpp:68-117``): the per-cell math of :func:`build_touched`
    over all cells.  A sparse map raises ValueError, as in the JAX package:
    it would give every cell a ring row."""
    if cfg.ring_rows > 0:
        raise ValueError(
            "the dense build() needs one ring row per cell; sparse maps "
            "(MapConfig.ring_rows > 0) must build through build_touched "
            "(the slam_step path)"
        )
    ids = torch.arange(cfg.num_cells, device=state.slot_idx.device)
    return build_touched(state, cfg, ids)


def reset(state: NdtMapState) -> NdtMapState:
    """Full zero reset, in place (JAX ``ndt_map.reset``: a fresh map, where
    the reference's ``NDTCell::reset`` keeps the stale Gaussians); a sparse
    ring's ``ring_map`` goes back to -1, unassigned."""
    for f in dataclasses.fields(state):
        getattr(state, f.name).zero_()
    state.ring_map.fill_(-1)
    return state


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
