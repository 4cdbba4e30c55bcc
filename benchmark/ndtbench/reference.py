"""The plain reference: NDT maps, the three NDT costs and the PSO solver.

Written from the upstream semantics (``ndtpso_slam``: ``ndtcell.cpp``,
``ndtframe.cpp``, ``core.cpp``) and the frozen Threefry draw protocol that
the upstream C++ golden model, the JAX engine and the program share, in
plain PyTorch at any dtype (float64 for the reference, bfloat16 for the
precision control) on any device.  It imports nothing of the program and is
handed only raw inputs (ranges, points, keys) and the outputs it judges.

* Threefry-2x32 (20 rounds) in pure counter mode, and the PSO draw layout:
  pair k < 3 seeds the global best, pair 3 + 3j + k initialises particle j,
  pair 3 + 3P + 3Pi + 3j + k gives iteration i's (r1, r2); a uniform is
  ``(bits >> 8) * 2**-24``.
* :class:`NdtMap`: the sliding-window NDT grid (``NDTCell``): per cell an
  open slot and a ring of ``window_slots`` closed ones, each holding a sum,
  a count and a scatter about the window mean of its time; a cell builds
  from the window once it holds more than 2 points, with the regularized
  inverse (``ndtcell.cpp:93-111``), and rotates its ring when its open slot
  holds more than ``slot_capacity`` points.  Moments are kept about the
  cell's centre.  Building a cell again with no new points evicts its
  oldest slot, so building this scan's cells and last scan's is building
  every cell that can have changed.
* Costs: :func:`exact_cost` (``core.cpp:26-48``); the stencil cost, the
  exact cost restricted to the (2r+1)² cells around each point's cell at the
  solve's guess (a point outside them scores 0); the frozen cost, each point
  held to the cell it falls in at a binding pose (the swarm's incumbent),
  scored at the particle's pose as ``exp(-max(d'Λd, 0)/2)``.
* :func:`pso`: the synchronous-global-best PSO of ``core.cpp:50-116``, B
  solves at once: every particle sees the global best of the previous
  iteration, a minimum is the first minimal index, every improvement test is
  a strict ``<``.
* :func:`relocalize`: the tracking-loss relocalization as the JAX package
  describes it (``models/slam.py:_relocalize``), from a configuration's
  ``recovery`` block: a dense pose grid about the last pose scored with the
  exact cost on an inflated map, K hypotheses by non-maximum suppression,
  K swarms of the frozen cost refining them on a lightly inflated map and
  polishing them on the map itself, the winner by the exact cost.
"""

from __future__ import annotations

import dataclasses
import math

import torch

M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
U01 = 1.0 / (1 << 24)

# NDTFrame::align's cold-start deviation (ndtframe.cpp:253) and the global
# best seed's near-zero deviation (core.cpp:53).
FIRST_DEVIATION = (0.1, 0.1, 3.1415e-3)
ZERO_DEVIATION = (1e-4, 1e-4, 1e-5)
# ndtcell.cpp:103, config.h:5.
EIG_RATIO = 1e-3
SLOT_CAPACITY = 50
LASER_IGNORE_EPSILON = 0.1
STENCIL_RADIUS = 2


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on u32 words (Python ints or int64
    tensors)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    for block in range(5):
        for r in _ROT_A if block % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & M32
    return x0, x1


def node_key(seed: int, step: int):
    """The SLAM node's key of scan ``step``: threefry(base, (step, 0)), the
    base key (seed, seed ^ 0x9E3779B9) of the node's ``seed``."""
    base = (seed & M32, (seed ^ 0x9E3779B9) & M32)
    return threefry(base[0], base[1], step & M32, 0)


def pso_draws(keys: torch.Tensor, population: int, iterations: int, dtype):
    """Every uniform of B solves: (u_gbest [B, 3], u_pop [B, P, 3],
    r1 [B, I, P, 3], r2 [B, I, P, 3]).  keys: [B, 2] int64 u32 words."""
    k0, k1 = keys[:, 0:1] & M32, keys[:, 1:2] & M32
    base = 3 + 3 * population
    ctr = torch.arange(base + 3 * population * iterations, dtype=torch.int64,
                       device=keys.device)[None, :]
    lo, hi = threefry(k0, k1, ctr, torch.zeros_like(ctr))
    lo = (lo >> 8).to(dtype) * U01
    hi = (hi >> 8).to(dtype) * U01
    b = keys.shape[0]
    return (lo[:, :3], lo[:, 3:base].reshape(b, population, 3),
            lo[:, base:].reshape(b, iterations, population, 3),
            hi[:, base:].reshape(b, iterations, population, 3))


def _select_min(cost, pos):
    """(min cost, the pos row at the first argmin) over the particle axis."""
    m = cost.amin(dim=-1, keepdim=True)
    p = cost.shape[-1]
    iota = torch.arange(p, device=cost.device)
    first = torch.where(cost == m, iota, p).amin(dim=-1).clamp(max=p - 1)
    return m[..., 0], pos[torch.arange(pos.shape[0], device=pos.device), first]


def pso(keys, guesses, deviations, cost_fn, population, iterations, w=0.8, c1=2.0, c2=2.0,
        w_damping=1.0, record=None):
    """B PSO solves.  cost_fn(poses [B, P, 3], binds [B, 3]) -> [B, P]; the
    binds are each solve's global best at the start of the evaluation.
    Returns (pose [B, 3], cost [B]) in the guesses' dtype.  ``record``, a
    list, receives the global best (pose, cost) after the start and after
    each iteration."""
    dtype = guesses.dtype
    u_g, u_p, r1s, r2s = pso_draws(keys, population, iterations, dtype)
    zero = torch.tensor(ZERO_DEVIATION, dtype=dtype, device=guesses.device)
    g_pos = guesses + (2.0 * u_g - 1.0) * zero
    g_cost = cost_fn(g_pos[:, None, :], guesses)[:, 0]
    pos = guesses[:, None, :] + (2.0 * u_p - 1.0) * deviations[:, None, :]
    cost = cost_fn(pos, guesses)
    bc, bp = _select_min(cost, pos)
    imp = bc < g_cost
    gbest = torch.where(imp[:, None], bp, g_pos)
    gcost = torch.where(imp, bc, g_cost)
    if record is not None:
        record.append((gbest, gcost))
    vel = torch.zeros_like(pos)
    pbest, pcost = pos, cost
    wt = torch.tensor(w, dtype=dtype, device=guesses.device)
    for i in range(iterations):
        vel = wt * vel + c1 * r1s[:, i] * (pbest - pos) + c2 * r2s[:, i] * (gbest[:, None] - pos)
        pos = pos + vel
        cost = cost_fn(pos, gbest)
        better = cost < pcost
        pbest = torch.where(better[..., None], pos, pbest)
        pcost = torch.where(better, cost, pcost)
        bc, bp = _select_min(pcost, pbest)
        imp = bc < gcost
        gbest = torch.where(imp[:, None], bp, gbest)
        gcost = torch.where(imp, bc, gcost)
        if record is not None:
            record.append((gbest, gcost))
        wt = wt * w_damping
    return gbest, gcost


# ----------------------------------------------------------------- geometry


def transform(points, poses):
    """points [..., N, 2] by poses [..., 3] -> [..., N, 2]."""
    c = torch.cos(poses[..., 2])[..., None]
    s = torch.sin(poses[..., 2])[..., None]
    x = points[..., 0] * c - points[..., 1] * s + poses[..., 0][..., None]
    y = points[..., 0] * s + points[..., 1] * c + poses[..., 1][..., None]
    return torch.stack([x, y], dim=-1)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A square frame of ``size`` metres cut into cells of ``side`` metres,
    centred on the origin (``ndtframe.cpp:19-66``)."""

    size: float
    side: float

    @property
    def width(self) -> int:
        return int(math.ceil(self.size / self.side))

    @property
    def cells(self) -> int:
        return self.width * self.width

    def coords(self, q):
        """(ix, iy) int64 and the strict-border in-frame mask of points q."""
        half = self.size / 2.0
        x, y = q[..., 0], q[..., 1]
        inb = (x > -half) & (x < half) & (y > -half) & (y < half)
        big = float(1 << 30)
        ix = torch.floor((x + half) / self.side).clamp(-big, big).to(torch.int64)
        iy = torch.floor((y + half) / self.side).clamp(-big, big).to(torch.int64)
        return ix, iy, inb

    def centers(self, idx, dtype):
        ix = (idx % self.width).to(dtype)
        iy = torch.div(idx, self.width, rounding_mode="floor").to(dtype)
        half = self.size / 2.0
        return torch.stack([(ix + 0.5) * self.side - half, (iy + 0.5) * self.side - half], -1)


def scan_points(ranges, angle_min, angle_increment, range_max, max_beams, mount, dtype, device,
                frame_half=None):
    """A laser scan [..., n] as padded points [..., max_beams, 2] and their
    mask (``NDTFrame::loadLaser``): a beam counts when 0.1 < r < range_max;
    the bearings angle_min + i·increment; the points moved by ``mount``
    (x, y, θ) when given, and dropped outside the frame of half-width
    ``frame_half`` when given."""
    r = torch.as_tensor(ranges).to(device=device, dtype=torch.float64)
    n = r.shape[-1]
    r = torch.nn.functional.pad(r, (0, max_beams - n))
    th = angle_min + angle_increment * torch.arange(max_beams, dtype=torch.float64, device=device)
    valid = (r > 0.0) & (r < range_max) & (r > LASER_IGNORE_EPSILON)
    pts = torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)
    if mount is not None and any(abs(v) > 1e-9 for v in mount):
        pts = transform(pts, torch.tensor(mount, dtype=torch.float64, device=device))
    if frame_half is not None:
        valid = valid & (pts[..., 0].abs() < frame_half) & (pts[..., 1].abs() < frame_half)
    return pts.to(dtype), valid


def regularized_inverse(cov):
    """Packed (xx, xy, yy) inverse of packed covariances (``ndtcell.cpp:93-111``):
    the adjugate over the determinant, the determinant replaced by 1e-3·λ₁²
    where λ₂ < 1e-3·λ₁."""
    a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
    half_tr = (a + c) / 2.0
    disc = torch.sqrt(torch.square((a - c) / 2.0) + torch.square(b))
    large, small = half_tr + disc, half_tr - disc
    det = torch.where(small < EIG_RATIO * large, EIG_RATIO * large * large, a * c - b * b)
    return torch.stack([c / det, -b / det, a / det], -1)


def quad(icov, d):
    return (icov[..., 0] * d[..., 0] * d[..., 0] + 2.0 * icov[..., 1] * d[..., 0] * d[..., 1]
            + icov[..., 2] * d[..., 1] * d[..., 1])


# ---------------------------------------------------------------------- map


class NdtMap:
    """The sliding-window NDT grid, dense over the frame's cells (one spare
    row takes the dropped points), at ``dtype`` on ``device``."""

    def __init__(self, grid: Grid, slots: int, dtype, device, capacity=SLOT_CAPACITY):
        self.grid, self.slots, self.dtype, self.capacity = grid, slots, dtype, capacity
        r = grid.cells + 1
        f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        i = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
        self.cur_sum, self.cur_n, self.cur_m2 = f(r, 2), i(r), f(r, 3)
        self.g_sum, self.g_n, self.g_cov = f(r, 2), i(r), f(r, 3)
        self.s_sum, self.s_n, self.s_cov = f(r, slots, 2), i(r, slots), f(r, slots, 3)
        self.slot = i(r)
        self.mean_c, self.icov = f(r, 2), f(r, 3)
        self.built = torch.zeros(r, dtype=torch.bool, device=device)

    def cell_ids(self, q, valid):
        """Cell ids of world points q [N, 2] (the spare row where dropped)."""
        ix, iy, inb = self.grid.coords(q)
        w = self.grid.width
        ok = valid & inb & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < w)
        return torch.where(ok, ix + w * iy, self.grid.cells)

    def add(self, q, valid):
        """Add world points q [N, 2] (``NDTCell::addPoint``); returns the
        cell ids (the spare row where dropped)."""
        ids = self.cell_ids(q, valid)
        d = (q - self.grid.centers(ids, self.dtype)).to(self.dtype)
        self.cur_sum.index_add_(0, ids, d)
        self.cur_n.index_add_(0, ids, torch.ones_like(ids))
        self.cur_m2.index_add_(0, ids, torch.stack([d[:, 0] * d[:, 0], d[:, 0] * d[:, 1],
                                                    d[:, 1] * d[:, 1]], -1))
        self.built[ids] = False
        return ids

    def build(self, ids):
        """Build cells ``ids`` (``NDTCell::build``, ``ndtcell.cpp:36-68``)."""
        ids = torch.unique(ids[ids < self.grid.cells])
        s = self.slot[ids]
        old_sum, old_n, old_cov = self.s_sum[ids, s], self.s_n[ids, s], self.s_cov[ids, s]
        cur_sum, cur_n, cur_m2 = self.cur_sum[ids], self.cur_n[ids], self.cur_m2[ids]
        g_sum = self.g_sum[ids] + cur_sum - old_sum
        g_n = self.g_n[ids] + cur_n - old_n
        has = g_n > 2
        n = g_n.clamp(min=1).to(self.dtype)[:, None]
        mean = g_sum / n
        nc = cur_n.to(self.dtype)
        mx, my, sx, sy = mean[:, 0], mean[:, 1], cur_sum[:, 0], cur_sum[:, 1]
        cov_cur = torch.stack([cur_m2[:, 0] - 2.0 * mx * sx + nc * mx * mx,
                               cur_m2[:, 1] - mx * sy - my * sx + nc * mx * my,
                               cur_m2[:, 2] - 2.0 * my * sy + nc * my * my], -1)
        g_cov = self.g_cov[ids] + cov_cur - old_cov
        h = has[:, None]
        self.mean_c[ids] = torch.where(h, mean, self.mean_c[ids])
        self.icov[ids] = torch.where(h, regularized_inverse(g_cov / n), self.icov[ids])
        self.built[ids] = self.built[ids] | has
        self.g_sum[ids], self.g_n[ids] = g_sum, g_n
        self.g_cov[ids] = torch.where(h, g_cov, self.g_cov[ids])
        self.s_sum[ids, s], self.s_n[ids, s] = cur_sum, cur_n
        self.s_cov[ids, s] = torch.where(h, cov_cur, old_cov)
        rot = cur_n > self.capacity
        self.slot[ids] = torch.where(rot, (s + 1) % self.slots, s)
        self.cur_sum[ids] = torch.where(rot[:, None], 0.0, cur_sum)
        self.cur_n[ids] = torch.where(rot, 0, cur_n)
        self.cur_m2[ids] = torch.where(rot[:, None], 0.0, cur_m2)

    def snapshot(self):
        """(world means [C, 2], inverse covariances [C, 3], built [C])."""
        c = self.grid.cells
        idx = torch.arange(c, device=self.built.device)
        return self.grid.centers(idx, self.dtype) + self.mean_c[:c], self.icov[:c], self.built[:c]


# -------------------------------------------------------------------- costs


def exact_cost(poses, snap, grid: Grid, points, valid):
    """-Σ exp(-d'Λd/2) over the points' cells at each pose (``core.cpp:26-48``).
    poses [..., 3], points [N, 2] -> [...]."""
    mean, icov, built = snap
    q = transform(points, poses)
    ix, iy, inb = grid.coords(q)
    ok = inb & valid & (ix >= 0) & (ix < grid.width) & (iy >= 0) & (iy < grid.width)
    idx = torch.where(ok, ix + grid.width * iy, 0)
    ok = ok & built[idx]
    s = torch.exp(-0.5 * quad(icov[idx], q - mean[idx]))
    return -torch.where(ok, s, torch.zeros((), dtype=s.dtype, device=s.device)).sum(-1)


def _anchor(guesses, points, grid: Grid):
    """Each point's cell at its solve's guess, and whether it is in the grid."""
    ax, ay, _ = grid.coords(transform(points, guesses))
    return ax, ay, (ax >= 0) & (ax < grid.width) & (ay >= 0) & (ay < grid.width)


def _stencil_rows(q, anchor, snaps, grid: Grid, valid, per_solve):
    """The cells of points q [B, ..., N, 2] within the stencil of their
    anchors: (rows [B, ..., N], mask)."""
    ax, ay, a_in = anchor
    ix, iy, inb = grid.coords(q)
    extra = q.dim() - ax.dim() - 1
    view = lambda t: t.view(t.shape[0], *([1] * extra), t.shape[-1])
    ax, ay, a_in, valid = view(ax), view(ay), view(a_in), view(valid)
    r = STENCIL_RADIUS
    ok = (((ix - ax).abs() <= r) & ((iy - ay).abs() <= r) & a_in & inb & valid
          & (ix >= 0) & (ix < grid.width) & (iy >= 0) & (iy < grid.width))
    idx = torch.where(ok, ix + grid.width * iy, 0)
    return idx, ok & _gather(snaps[2], idx, per_solve)


def _gather(field, idx, per_solve):
    if not per_solve:
        return field[idx]
    b = torch.arange(idx.shape[0], device=idx.device).view(-1, *([1] * (idx.dim() - 1)))
    return field[b, idx]


def stencil_cost_fn(guesses, snaps, grid: Grid, points, valid, per_solve):
    """The K1 cost of B solves: the exact cost over the stencil of each
    point's cell at the solve's guess.  points [B, N, 2]."""
    anchor = _anchor(guesses, points, grid)

    def cost(poses, _binds):
        q = transform(points[:, None], poses)  # [B, P, N, 2]
        idx, ok = _stencil_rows(q, anchor, snaps, grid, valid, per_solve)
        d = q - _gather(snaps[0], idx, per_solve)
        s = torch.exp(-0.5 * quad(_gather(snaps[1], idx, per_solve), d))
        return -torch.where(ok, s, torch.zeros((), dtype=s.dtype, device=s.device)).sum(-1)

    return cost


def frozen_cost_fn(guesses, snaps, grid: Grid, points, valid, per_solve):
    """The K2 cost of B solves: each point held to its stencil cell at the
    binding pose, scored at the particle's pose as exp(-max(d'Λd, 0)/2)."""
    anchor = _anchor(guesses, points, grid)

    def cost(poses, binds):
        idx, ok = _stencil_rows(transform(points, binds), anchor, snaps, grid, valid, per_solve)
        mean = _gather(snaps[0], idx, per_solve)[:, None]
        icov = _gather(snaps[1], idx, per_solve)[:, None]
        d = transform(points[:, None], poses) - mean  # [B, P, N, 2]
        s = torch.exp(-0.5 * torch.clamp(quad(icov, d), min=0.0))
        return -torch.where(ok[:, None], s, torch.zeros((), dtype=s.dtype, device=s.device)).sum(-1)

    return cost


# ------------------------------------------------------------------- raster


class Raster:
    """The occupancy raster of a map (``ndtframe.cpp:69-112``): each built
    cell's Gaussian sampled at the centres of its per_cell x per_cell
    sub-cells, stored as int8(p·100) truncated; refreshed for the cells a
    scan touched."""

    def __init__(self, grid: Grid, sub: float, device):
        self.grid, self.sub = grid, sub
        self.n = int(math.ceil(grid.size / sub))
        self.per = int(math.floor(grid.side / sub))
        self.og = torch.zeros(self.n * self.n + 1, dtype=torch.int8, device=device)

    def update(self, nmap: NdtMap, ids):
        """Refresh the sub-cells of the built cells among ``ids``."""
        ids = torch.unique(ids[ids < self.grid.cells])
        ids = ids[nmap.built[ids]]
        dt = nmap.dtype
        k = torch.arange(self.per * self.per, device=ids.device)
        w = self.grid.width
        ox = (ids % w)[:, None] * self.per + (k % self.per)[None]
        oy = torch.div(ids, w, rounding_mode="floor")[:, None] * self.per + (k // self.per)[None]
        half = self.grid.size / 2.0
        c = torch.stack([ox.to(dt) * self.sub + self.sub / 2 - half,
                         oy.to(dt) * self.sub + self.sub / 2 - half], -1)
        mean = (self.grid.centers(ids, dt) + nmap.mean_c[ids])[:, None]
        p = torch.exp(-0.5 * quad(nmap.icov[ids][:, None], c - mean))
        v = torch.clamp(torch.nan_to_num(p * 100.0, nan=0.0, posinf=127.0), -128.0, 127.0)
        self.og[(oy * self.n + ox).reshape(-1)] = v.to(torch.int8).reshape(-1)

    def raster(self):
        return self.og[: self.n * self.n].view(self.n, self.n)


# ----------------------------------------------------------------- recovery

# The relocalization's constants (the JAX package's models/slam.py:
# _relocalize): the polish's deviation; the counters that derive its keys
# from the step's key, threefry(key, RELOC_KEY), then one key per swarm,
# threefry(that, (k, REFINE_CTR)) to refine and threefry(that, (k + 0x907,
# 0x13)) to polish; the map size from which the grid scores every second
# beam (grid_beam_stride 0).
POLISH_DEVIATION = (0.1, 0.1, 0.05)
RELOC_KEY = (0x5EC0, 0xFA11)
REFINE_CTR = 0x5117
POLISH_CTR = (0x907, 0x13)
AUTO_STRIDE_MIN_CELLS = 65536
# Grid poses scored at once.
GRID_CHUNK = 4096


def smooth(snap, sigma):
    """The snapshot with every cell's Σ inflated to Σ + σ²I, from its packed
    inverse Λ (Σ = adj(Λ)/det(Λ)); a cell whose Λ has det <= 1e-20 counts
    as unbuilt."""
    mean, icov, built = snap
    a, b, c = icov[..., 0], icov[..., 1], icov[..., 2]
    det = a * c - b * b
    ok = det > 1e-20
    det = torch.where(ok, det, torch.ones_like(det))
    s2 = sigma * sigma
    sa, sb, sc = c / det + s2, -b / det, a / det + s2
    d2 = sa * sc - sb * sb
    return mean, torch.stack([sc / d2, -sb / d2, sa / d2], -1), built & ok


def window_origin(pose, grid: Grid, ps: int):
    """The corner cell (ox, oy) of the ps x ps window about ``pose``'s cell,
    moved to lie inside the grid."""
    ix, iy, _ = grid.coords(pose[:2])
    corner = lambda i: min(max(int(i) - ps // 2, 0), grid.width - ps)
    return corner(ix), corner(iy)


def window_cost_fn(snap, grid: Grid, points, valid, window):
    """The frozen cost of K swarms over one scan and one map: each point held
    to the cell it falls in at its swarm's binding pose (a cell outside the
    ps x ps ``window`` = (ox, oy, ps) counts as unbuilt; ``window`` None:
    the whole map), scored at the particle's pose as exp(-max(d'Λd, 0)/2).
    points [N, 2]; cost(poses [K, P, 3], binds [K, 3]) -> [K, P]."""
    mean, icov, built = snap
    w = grid.width

    def cost(poses, binds):
        ix, iy, inb = grid.coords(transform(points, binds))  # [K, N]
        ok = inb & valid & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < w)
        if window is not None:
            ox, oy, ps = window
            ok = ok & (ix >= ox) & (ix < ox + ps) & (iy >= oy) & (iy < oy + ps)
        idx = torch.where(ok, ix + w * iy, 0)
        ok = ok & built[idx]
        d = transform(points, poses) - mean[idx][:, None]  # [K, P, N, 2]
        s = torch.exp(-0.5 * torch.clamp(quad(icov[idx][:, None], d), min=0.0))
        return -torch.where(ok[:, None], s, torch.zeros((), dtype=s.dtype, device=s.device)).sum(-1)

    return cost


def reloc_grid(last, rc: dict):
    """The dense pose grid over ±``spread`` about ``last``, [G, 3] (x
    slowest, θ fastest), at ``last``'s dtype."""
    (nx, ny, nt), (sx, sy, st) = rc["grid"], rc["spread"]
    lin = lambda n, s: torch.linspace(-s, s, n, dtype=torch.float64, device=last.device)
    gx, gy, gt = torch.meshgrid(lin(nx, sx), lin(ny, sy), lin(nt, st), indexing="ij")
    off = torch.stack([gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)], -1).to(last.dtype)
    return last + off


def nms_top_k(poses, costs, k: int, radius):
    """K picks from poses [G, 3], each the first minimum of the costs left,
    after which every pose within ±radius of it (θ wrapped) is left out.
    Returns [K, 3], best first."""
    two_pi = 2.0 * math.pi
    inf = torch.full((), float("inf"), dtype=costs.dtype, device=costs.device)
    picks = []
    for _ in range(k):
        _, best = _select_min(costs[None], poses[None])
        d = torch.abs(poses - best)
        dth = torch.minimum(d[:, 2], two_pi - d[:, 2])
        near = (d[:, 0] <= radius[0]) & (d[:, 1] <= radius[1]) & (dth <= radius[2])
        costs = torch.where(near, inf, costs)
        picks.append(best[0])
    return torch.stack(picks)


def swarm_keys(key, k: int, c0: int, c1: int, device):
    """The K swarms' keys [K, 2]: threefry(threefry(key, RELOC_KEY),
    (c0 + j, c1)) for j < K."""
    r0, r1 = threefry(key[0] & M32, key[1] & M32, *RELOC_KEY)
    j = torch.arange(k, dtype=torch.int64, device=device)
    x0, x1 = threefry(r0, r1, j + c0, torch.full_like(j, c1))
    return torch.stack([x0, x1], -1)


def relocalize(key, snap, grid: Grid, points, valid, last, failed, rc: dict):
    """The relocalization of one step about the last served pose ``last``
    after a failed align at ``failed``, at their dtype (module docstring):

    1. the exact cost of every pose of :func:`reloc_grid` on the map
       inflated by ``grid_sigma``, on every stride-th beam (``grid_beam_stride``;
       0: 2 on a map of AUTO_STRIDE_MIN_CELLS cells or more, else 1);
    2. K = ``k_hypotheses`` picks by :func:`nms_top_k` within 1.5 grid
       spacings, the first two replaced by ``last`` and ``failed``;
    3. K swarms (``pso``) of :func:`window_cost_fn` in the ``patch_cells``
       window about ``last`` (the whole map where that is 0 or not smaller
       than the grid), at ``deviation`` on the map inflated by
       ``refine_sigma``, then at POLISH_DEVIATION on the map itself;
    4. the winner: the first minimum of the exact cost.

    points [N, 2]; key (k0, k1) the step's key.  Returns (pose [3], exact
    cost [])."""
    k = int(rc["k_hypotheses"])
    poses = reloc_grid(last, rc)
    stride = int(rc["grid_beam_stride"]) or (2 if grid.cells >= AUTO_STRIDE_MIN_CELLS else 1)
    coarse = smooth(snap, float(rc["grid_sigma"]))
    sp, sv = points[::stride], valid[::stride]
    costs = torch.cat([exact_cost(c, coarse, grid, sp, sv) for c in poses.split(GRID_CHUNK)])
    (nx, ny, nt), (sx, sy, st) = rc["grid"], rc["spread"]
    spacing = torch.tensor([2.0 * sx / max(nx - 1, 1), 2.0 * sy / max(ny - 1, 1),
                            2.0 * st / max(nt - 1, 1)], dtype=last.dtype, device=last.device)
    hypo = nms_top_k(poses, costs, k, 1.5 * spacing)
    hypo[0] = last
    if k > 1:
        hypo[1] = failed
    ps = int(rc["patch_cells"])
    window = (*window_origin(last, grid, ps), ps) if 0 < ps < grid.width else None
    pso_cfg = rc["pso"]

    def swarms(keys, start, deviation, m):
        dev = torch.tensor(deviation, dtype=last.dtype, device=last.device).expand(k, 3)
        pose, _ = pso(keys, start, dev, window_cost_fn(m, grid, points, valid, window),
                      int(pso_cfg["population"]), int(pso_cfg["iterations"]),
                      float(pso_cfg["w"]), float(pso_cfg["c1"]), float(pso_cfg["c2"]),
                      float(pso_cfg["w_damping"]))
        return pose

    sigma = float(rc["refine_sigma"])
    refined = swarms(swarm_keys(key, k, 0, REFINE_CTR, last.device), hypo, rc["deviation"],
                     smooth(snap, sigma) if sigma > 0 else snap)
    polished = swarms(swarm_keys(key, k, *POLISH_CTR, last.device), refined, POLISH_DEVIATION,
                      snap)
    cost, pose = _select_min(exact_cost(polished, snap, grid, points, valid)[None], polished[None])
    return pose[0], cost[0]
