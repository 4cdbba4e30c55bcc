"""How ``correct`` is decided: the plain reference over what the timed path
produced.

The node (``judge_node``).  The SLAM node serves one pose per scan.  The
reference reads the served poses (the outputs it judges) and nothing else
of the program: it builds its own map from the scans and the served poses,
scan by scan, in float64, and at sampled steps solves the step itself from
the served history (the previous served pose as the guess, twice the last
served motion as the deviation, the node's key of that step), with the
stencil cost of the node's cost mode.  Compared, each against its limit:

* ``pose_xy_p75_m``, ``pose_th_p75_rad``: the 75th percentile over the
  sampled steps of the gap between the served pose and the reference's
  solve (a percentile: a PSO near-tie now and then sends a sound solve
  elsewhere along a flat direction of the cost, so the widest gap swings);
* ``parted_pct``: the share of the sampled steps whose served pose parts
  from the reference's solve by more than the configuration's ``parted``
  distances (``xy_m``, ``th_rad``), in percent: near-ties part a few
  samples in a hundred, so a fault in one step of a few shows here where
  the percentiles stay at rounding;
* ``score_gap_p75``: the 75th percentile of the amount by which the served
  pose's mean NDT score per valid beam, on the reference's map, lies below
  the reference's solve's;
* ``fitness_gap``: the widest gap between the node's exact rescore (its
  fitness) and the reference's score of the served pose (with recovery
  on, over the steps whose fitness float32 fixes: see below);
* ``map_off_pct``: the share of the cells built on either side whose built
  flag, world mean (by more than 1e-4 m) or inverse covariance (by more
  than 1% of its norm) differ between the node's final map and the
  reference's;
* ``raster_off_pct``: the share of the occupancy sub-cells written on either
  side whose int8 values differ by more than 1 (``p·100`` truncates, so a
  p one rounding apart can land on either side of an integer).

A node with tracking-loss recovery on (the configuration's ``recovery``
block) is replayed by the program's rule: the scan played at each step is
the traffic's schedule's; a scan with fewer than ``min_valid_beams`` valid
beams dead-reckons at the last motion and stays out of the map; the motion
after a step whose relocalization was accepted (the run's ``events``, read
as the served poses are) is 0, so the next align's deviation is 0; and at a
sampled step the reference relocalizes (``reference.relocalize``) where its
own align's fitness lies under ``fitness_threshold`` after the cold start,
and takes the relocalized pose where its exact cost is strictly lower than
the align's and its fitness lies in [``accept_fitness``, 1].  Steps
``events`` (kidnaps sampled from the seed) and the step after each are
judged apart:

* ``event_xy_p75_m``, ``event_th_p75_rad``, ``event_score_gap_p75``: as
  above, over those steps;
* ``accept_differ_pct``: the share of the sampled kidnaps at which the
  program and the reference differ on accepting a relocalization.

The numbers above keep their meaning over the other sampled steps.  A
kidnapped node's map gains cells of three or so points a few millimetres
apart, whose regularized inverse (``ndtcell.cpp:93-111``: the determinant
replaced, the adjugate kept) divides by ~1e-15: a float32 rounding of the
covariance flips the sign of its weak axis, and a beam there scores
exp(+large), up to infinity, in a sound float32 run where the float64
reference scores sanely.  So with recovery on ``fitness_gap`` leaves out
the steps whose fitness float32 does not fix: where a float32-sized
error in each covariance entry of the cells the served pose's beams land
in, on the reference's map, could move the fitness by more than
``FIT_RESOLVED`` (:func:`fitness_spread`); the steps left out are reported
(``fitness_left_out``).
``event_parted_pct`` (``parted_pct`` over the event steps) is reported
(``"reported"``) and not compared: a sound relocalization's swarms end
millimetres to centimetres from the float64 reference's, and now and then
in another basin that scores as well, so on sound runs it reads about half
the control's 100% and no limit parts the two (PERF.md §6, PR 20); the
score gap is compared in its place.

Batch matching (``judge_batch``).  Each sampled solve is solved again by the
reference in float64 from the same inputs (the benchmark's own maps and
points, the same key, guess and deviation) with the frozen cost.  Compared
are the 75th percentiles over the sampled solves of the pose gap
(``pose_xy_p75_m``), of the gap between the two poses' stencil scores per
valid point (``score_gap_p75``), and of the gap between the solve's
reported cost and the reference's (``cost_gap_p75``), and the share of the
sampled solves whose pose parts from the reference's beyond ``parted``
(``parted_pct``).

With ``witness`` a judge also looks at each parted sample (``readings.py``
asks for it; runs do not): the reference solved again in float32, and, for
the node, in float64 from its inputs rounded to float32; for batch
matching, the first iteration at which the program's global best (the
program rerun with each iteration budget) parts from the reference's, and
both picks' float64 costs there against the float32 resolution.

A judge takes a candidate: the program's outputs, or, for the precision
control, a stand-in computed in a lower precision on the same inputs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ndtbench import reference as R

MEAN_TOL_M = 1e-4
ICOV_RTOL = 1e-2
RASTER_TOL = 1
# A float32 error in a cell's covariance entries, as a share of the size of
# its moments (fitness_spread): four times float32's epsilon (PERF.md §6
# gives the steps it leaves out at one to 64 times).
COV_EPS = 4 * 2.0 ** -23
# The most by which that error may move a step's fitness for the step to
# count in fitness_gap: a third of the limit.
FIT_RESOLVED = 0.01


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a missing limit fails."""
    return {k: {"value": float(v), "limit": limits.get(k, float("nan"))}
            for k, v in numbers.items()}


def passed(chk: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in chk.values())


def parted_pct(dxy, dth, parted: dict) -> float:
    """The share, in percent, of samples whose pose gap exceeds ``parted``
    ({"xy_m", "th_rad"})."""
    off = (np.asarray(dxy) > parted["xy_m"]) | (np.asarray(dth) > parted["th_rad"])
    return 100.0 * float(off.mean()) if off.size else 0.0


def sample_rows(rng: np.random.Generator, candidates, count: int):
    """``count`` of ``candidates`` drawn without replacement, sorted."""
    candidates = np.asarray(candidates)
    count = min(count, len(candidates))
    return np.sort(rng.choice(candidates, size=count, replace=False))


# --------------------------------------------------------------------- node


class NodeReplay:
    """The reference node at ``dtype``: its map (and raster) built from the
    scans and the poses it is given, and its own solve of a step."""

    def __init__(self, node_cfg: dict, dtype, device):
        self.cfg, self.dtype, self.device = node_cfg, dtype, device
        self.grid = R.Grid(float(node_cfg["frame_size_m"]), float(node_cfg["cell_side_m"]))
        self.map = R.NdtMap(self.grid, int(node_cfg["window_slots"]), dtype, device)
        self.raster = (R.Raster(self.grid, float(node_cfg["og_cell_size_m"]), device)
                       if node_cfg.get("build_og") else None)
        self.prev = torch.zeros(0, dtype=torch.int64, device=device)

    def ingest(self, pose, pts, valid):
        ids = self.map.add(R.transform(pts, pose), valid)
        self.map.build(torch.cat([ids, self.prev]))
        if self.raster is not None:
            self.raster.update(self.map, ids)
        self.prev = ids


def node_solve(cfg: dict, grid: R.Grid, snap, key, guess, deviation, pts, valid):
    """The node's align at one step: a PSO solve of the stencil cost
    anchored at the guess, at the guess's dtype."""
    keys = torch.tensor([key], dtype=torch.int64, device=guess.device)
    cost = R.stencil_cost_fn(guess[None], snap, grid, pts[None], valid[None], False)
    pose, _ = R.pso(keys, guess[None], deviation[None], cost, int(cfg["pso_population"]),
                    int(cfg["pso_iterations"]))
    return pose[0]


def node_fitness(grid: R.Grid, snap, pose, pts, valid):
    """The exact rescore as the node reports it: the mean NDT score per valid
    beam at ``pose``."""
    cost = R.exact_cost(pose, snap, grid, pts, valid)
    return -cost / valid.sum().clamp(min=1).to(cost.dtype)


def fitness_spread(grid: R.Grid, snap, pose, pts, valid):
    """How far an error δ in each covariance entry of the cells that the
    beams at ``pose`` land in could move the fitness there, to first order;
    δ is ``COV_EPS`` times the size of the cell's moments (its mean's
    squared offset from the cell's centre plus its covariance's trace).
    A cell's inverse Λ is its covariance Σ's adjugate over a determinant
    D > 0 (``R.regularized_inverse``), which Λ's eigenvalues μ₁ <= μ₂ give
    back, with Σ's λ₁ >= λ₂: where μ₁ < 1e-3·μ₂ the ratio was regularized,
    D = 1e-3·λ₁², λ₁ = 1/(1e-3·μ₂), and D moves by a share ρ = 4δ/λ₁; else
    D = λ₁λ₂ = 1/(μ₁μ₂) and ρ = 2δ(μ₁ + μ₂).  A beam's q = d'Λd then lies
    within q(1 + ρ)^±1 ± e, e = δ(|dx| + |dy|)²/D through the adjugate; the
    spread is the mean over the valid beams of the scores exp(-q/2) at the
    two ends, the one less the other."""
    mean, icov, built = snap
    q = R.transform(pts, pose)
    ix, iy, inb = grid.coords(q)
    ok = inb & valid & (ix >= 0) & (ix < grid.width) & (iy >= 0) & (iy < grid.width)
    idx = torch.where(ok, ix + grid.width * iy, 0)
    ok = ok & built[idx]
    lam, d = icov[idx], q - mean[idx]
    a, b, c = lam[..., 0], lam[..., 1], lam[..., 2]
    half_tr = (a + c) / 2.0
    disc = torch.sqrt(torch.square((a - c) / 2.0) + torch.square(b))
    mu1, mu2 = half_tr - disc, half_tr + disc
    reg = mu1 < R.EIG_RATIO * mu2
    inv_d = torch.where(reg, R.EIG_RATIO * mu2 * mu2, mu1 * mu2)
    off = mean[idx] - grid.centers(idx, mean.dtype)
    delta = COV_EPS * (torch.square(off).sum(-1) + (a + c) / inv_d)
    rho = torch.where(reg, 4.0 * delta * R.EIG_RATIO * mu2, 2.0 * delta * (mu1 + mu2))
    e = delta * torch.square(d[..., 0].abs() + d[..., 1].abs()) * inv_d
    qd = R.quad(lam, d)
    grow = torch.where(qd >= 0, 1.0 + rho, 1.0 / (1.0 + rho))
    s = torch.exp(-0.5 * (qd / grow - e)) - torch.exp(-0.5 * (qd * grow + e))
    s = torch.where(ok, s, torch.zeros((), dtype=s.dtype, device=s.device))
    return float(s.sum() / valid.sum().clamp(min=1))


def _deviation(served, t, dtype, device, motion=None):
    """NDTFrame::align's deviation at step t: the cold-start one for the
    first two aligns, then twice the last served motion (``motion`` [T, 3],
    where given: the motion the program keeps after each step)."""
    if t < 3:
        return torch.tensor(R.FIRST_DEVIATION, dtype=dtype, device=device)
    if motion is not None:
        return torch.abs(2.0 * motion[t - 1]).to(dtype)
    return torch.abs(2.0 * (served[t - 1] - served[t - 2])).to(dtype)


def _motions(served: np.ndarray, degraded: np.ndarray, accepted) -> np.ndarray:
    """The motion the program keeps after each step with recovery on: that
    of the step before where the scan dead-reckoned, 0 where a
    relocalization was accepted, else the served motion.  [T, 3]."""
    motion = np.zeros_like(served)
    for t in range(1, served.shape[0]):
        if degraded[t]:
            motion[t] = motion[t - 1]
        elif t not in accepted:
            motion[t] = served[t] - served[t - 1]
    return motion


def recovery_step(cfg: dict, rc: dict, grid: R.Grid, snap, key, guess, deviation, pts, valid,
                  t: int):
    """The reference's step t > 0 of a node with recovery on, at the guess's
    dtype: the align, then the relocalization where its fitness is under the
    threshold after the cold start (t >= 3), taken by the program's accept
    rule.  Returns (pose [3], relocalized pose accepted)."""
    pose = node_solve(cfg, grid, snap, key, guess, deviation, pts, valid)
    if t < 3:
        return pose, False
    n = valid.sum().clamp(min=1).to(guess.dtype)
    cost = R.exact_cost(pose, snap, grid, pts, valid)
    if not bool(-cost / n < rc["fitness_threshold"]):
        return pose, False
    rpose, rcost = R.relocalize(key, snap, grid, pts, valid, guess, pose, rc)
    rfit = -rcost / n
    if bool((rcost < cost) & (rfit >= rc["accept_fitness"]) & (rfit <= 1.0)):
        return rpose, True
    return pose, False


def judge_node(lap, node_cfg: dict, parted: dict, seed: int, served_poses: np.ndarray,
               fitness: np.ndarray, final_map: Optional[dict], raster: Optional[np.ndarray],
               sample, device, control: bool = False, witness: bool = False, index=None,
               recovery: Optional[dict] = None, accepted=(), events=()) -> dict:
    """The node's numbers (module docstring) over steps ``sample``.
    served_poses [T, 3], fitness [T]: what the node served; final_map
    {"mean": [C, 2] world, "icov": [C, 3], "built": [C]} and ``raster``
    [H, W] int8 after step T - 1; ``index`` [T]: the lap's scan played at
    each step (None: t mod L).  ``recovery``: the configuration's recovery
    block where recovery is on, else None; ``accepted``: the steps at which
    the node accepted a relocalization; ``events``: the sampled kidnap steps,
    judged with the step after each apart from ``sample``.  With
    ``control`` the candidate is not the node but the reference in bfloat16
    fed the same served history: its solve (and relocalization) and rescore
    on the reference's map rounded to bfloat16, its map and raster built in
    bfloat16 (the served poses, the fitness and ``accepted`` are read only
    for that history)."""
    f64, lo = torch.float64, torch.bfloat16
    ref = NodeReplay(node_cfg, f64, device)
    low = NodeReplay(node_cfg, lo, device) if control else None
    grid = ref.grid
    b = lap.beams
    pts, valid = R.scan_points(lap.ranges, b.angle_min, b.angle_increment, b.range_max,
                               int(node_cfg["max_beams"]), node_cfg.get("mount_trans"), f64,
                               device, frame_half=float(node_cfg["frame_size_m"]) / 2)
    served = torch.as_tensor(served_poses, dtype=f64, device=device)
    init = torch.tensor(node_cfg.get("init_pose", (0.0, 0.0, 0.0)), dtype=f64, device=device)
    n_steps = served.shape[0]
    index = np.arange(n_steps) % lap.ranges.shape[0] if index is None else np.asarray(index)
    rc = recovery
    degraded = np.zeros(n_steps, bool)
    motion = None
    accepted = set(int(t) for t in accepted)
    if rc is not None:
        degraded = valid.sum(-1).cpu().numpy()[index] < int(rc["min_valid_beams"])
        degraded[0] = False
        motion = torch.as_tensor(_motions(np.asarray(served_poses, np.float64), degraded,
                                          accepted), dtype=f64, device=device)
    kidnaps = set(int(t) for t in events)
    event_steps = kidnaps | {t + 1 for t in kidnaps if t + 1 < n_steps}
    want = set(int(t) for t in sample) | event_steps
    gaps = {"fitness_gap": 0.0}
    samples, event_samples, witnesses = [], [], []
    left_out = []  # with recovery on, the steps whose fitness float32 does not fix

    def solve(t, snap, key, guess, pts_t, v, dtype):
        """The reference's answer at step t > 0 at ``dtype``: (pose,
        relocalized pose accepted)."""
        if rc is None:
            return node_solve(node_cfg, grid, snap, key, guess, _deviation(served, t, dtype,
                                                                           device), pts_t, v), False
        if degraded[t]:
            return (served[t - 1] + motion[t - 1]).to(dtype), False
        return recovery_step(node_cfg, rc, grid, snap, key, guess,
                             _deviation(served, t, dtype, device, motion), pts_t, v, t)

    for t in range(n_steps):
        i = int(index[t])
        p, v = pts[i], valid[i]
        if t in want:
            snap = ref.map.snapshot()
            key = R.node_key(seed, t)
            mine, mine_acc = (init, False) if t == 0 else solve(t, snap, key, served[t - 1], p,
                                                                v, f64)
            if control:
                snap_lo = tuple(x.to(lo) if x.is_floating_point() else x for x in snap)
                cand, cand_acc = (init.to(lo), False) if t == 0 else solve(
                    t, snap_lo, key, served[t - 1].to(lo), p.to(lo), v, lo)
                cand_fit = float(node_fitness(grid, snap_lo, cand, p.to(lo), v))
                cand = cand.to(f64)
            else:
                cand, cand_fit, cand_acc = served[t], float(fitness[t]), t in accepted
            fit_cand = float(node_fitness(grid, snap, cand, p, v))
            fit_mine = float(node_fitness(grid, snap, mine, p, v))
            row = (t, float(torch.hypot(cand[0] - mine[0], cand[1] - mine[1])),
                   float(torch.abs(cand[2] - mine[2])), max(0.0, fit_mine - fit_cand),
                   abs(cand_fit - fit_cand))
            if t in event_steps:
                event_samples.append(row + (mine_acc, cand_acc))
            else:
                samples.append(row)
                if (witness and not control and t > 0 and not mine_acc and not degraded[t]
                        and parted_pct([row[1]], [row[2]], parted)):
                    witnesses.append(_node_witness(
                        node_cfg, grid, snap, key, served, t, p, v, mine, cand,
                        _deviation(served, t, f64, device, motion)))
                if rc is not None and not fitness_spread(grid, snap, cand, p, v) <= FIT_RESOLVED:
                    left_out.append(t)
                else:
                    gaps["fitness_gap"] = (max(gaps["fitness_gap"], row[4])
                                           if math.isfinite(row[4]) else float("nan"))
        v_in = torch.zeros_like(v) if degraded[t] else v  # a dead-reckoned scan stays out
        ref.ingest(served[t], p, v_in)
        if low is not None:
            low.ingest(served[t].to(lo), p.to(lo), v_in)
    if low is not None:
        mean, icov, built = (x.to(f64) if x.is_floating_point() else x
                             for x in low.map.snapshot())
        final_map = {"mean": mean, "icov": icov, "built": built}
        raster = None if low.raster is None else low.raster.raster()
    p75 = lambda rows, col: float(np.quantile([s[col] for s in rows], 0.75))
    for key, col in (("pose_xy_p75_m", 1), ("pose_th_p75_rad", 2), ("score_gap_p75", 3)):
        gaps[key] = p75(samples, col)
    gaps["parted_pct"] = parted_pct([s[1] for s in samples], [s[2] for s in samples], parted)
    if final_map is not None:
        gaps["map_off_pct"] = map_off_pct(ref.map, final_map, device)
    if ref.raster is not None and raster is not None:
        gaps["raster_off_pct"] = raster_off_pct(ref.raster.raster(), raster, device)
    reported = {}
    if rc is not None:
        reported["fitness_left_out"] = left_out
    if event_samples:
        gaps["event_xy_p75_m"] = p75(event_samples, 1)
        gaps["event_th_p75_rad"] = p75(event_samples, 2)
        gaps["event_score_gap_p75"] = p75(event_samples, 3)
        differ = [s[5] != s[6] for s in event_samples if s[0] in kidnaps]
        gaps["accept_differ_pct"] = 100.0 * float(np.mean(differ)) if differ else 0.0
        reported["event_parted_pct"] = parted_pct([s[1] for s in event_samples],
                                                  [s[2] for s in event_samples], parted)
    return {"numbers": gaps, "reported": reported, "samples": samples,
            "event_samples": event_samples, "witnesses": witnesses}


def _node_witness(cfg, grid, snap, key, served, t, pts, valid, mine, cand, dev) -> dict:
    """A parted node sample's align solved again by the reference in
    float32, and in float64 from its inputs (map, scan, guess, deviation
    ``dev``) rounded to float32: each solve's distance from the float64
    solve and from the served pose, and each pose's mean score per beam on
    the float64 map."""
    f64, f32 = torch.float64, torch.float32
    out = {"step": t}
    for name, back in (("f32", f32), ("f64_of_f32_inputs", f64)):
        conv = lambda x: x.to(f32).to(back) if x.is_floating_point() else x
        pose = node_solve(cfg, grid, tuple(conv(x) for x in snap), key, conv(served[t - 1]),
                          conv(dev), conv(pts), valid).to(f64)
        out[name] = _pose_report(grid, snap, pose, mine, cand, pts, valid)
    out["served"] = _pose_report(grid, snap, cand, mine, cand, pts, valid)
    out["f64_fitness"] = float(node_fitness(grid, snap, mine, pts, valid))
    return out


def _pose_report(grid, snap, pose, mine, cand, pts, valid) -> dict:
    gap = lambda a, b: [float(torch.hypot(a[0] - b[0], a[1] - b[1])), float(torch.abs(a[2] - b[2]))]
    return {"pose": pose.tolist(), "from_f64": gap(pose, mine), "from_served": gap(pose, cand),
            "fitness": float(node_fitness(grid, snap, pose, pts, valid))}


def map_off_pct(ref_map: R.NdtMap, got: dict, device) -> float:
    mean, icov, built = ref_map.snapshot()
    g_mean = torch.as_tensor(got["mean"], device=device).to(torch.float64)
    g_icov = torch.as_tensor(got["icov"], device=device).to(torch.float64)
    g_built = torch.as_tensor(got["built"], device=device).to(torch.bool)
    either = built | g_built
    both = built & g_built
    dm = torch.linalg.vector_norm(g_mean - mean, dim=-1)
    di = torch.linalg.vector_norm(g_icov - icov, dim=-1)
    ni = torch.linalg.vector_norm(icov, dim=-1)
    ok = both & (dm <= MEAN_TOL_M) & (di <= ICOV_RTOL * ni)
    n = int(either.sum())
    return 100.0 * float((either & ~ok).sum()) / max(n, 1)


def raster_off_pct(ref_og: torch.Tensor, got, device) -> float:
    got = torch.as_tensor(np.asarray(got.cpu() if torch.is_tensor(got) else got),
                          device=device).to(torch.int16)
    ref = ref_og.to(torch.int16)
    written = (ref != 0) | (got != 0)
    off = written & ((ref - got).abs() > RASTER_TOL)
    return 100.0 * float(off.sum()) / max(int(written.sum()), 1)


# -------------------------------------------------------------------- batch


def judge_batch(inputs: dict, sampled: list, cand_pose: np.ndarray, cand_cost: np.ndarray,
                map_cfg: dict, pso_cfg: dict, parted: dict, device, block: int = 8,
                budgets: Optional[Callable[[int], list]] = None) -> dict:
    """The batch numbers over ``sampled`` solves, [(pool row, key words)],
    whose candidate answers are cand_pose [S, 3] and cand_cost [S].
    inputs: the pool on the device: "mean" [pool, C, 2], "icov", "built",
    "points" [pool, N, 2], "valid", "guess" [pool, 3], "dev" [pool, 3].
    With ``budgets`` (sample j -> the program's [(pose [3], cost)] after
    1 .. I iterations) each parted sample is looked at (module docstring)."""
    f64 = torch.float64
    grid = R.Grid(float(map_cfg["size_m"]), float(map_cfg["cell_side_m"]))
    rows = torch.tensor([r for r, _ in sampled], dtype=torch.int64, device=device)
    keys = torch.tensor([k for _, k in sampled], dtype=torch.int64, device=device) & R.M32
    cand = torch.as_tensor(np.asarray(cand_pose), dtype=f64, device=device)
    poses, costs, scores = [], [], []
    for s in range(0, len(sampled), block):
        r = rows[s:s + block]
        snaps, pts, valid, guess, dev = _pairs(inputs, r, f64)
        cost = R.frozen_cost_fn(guess, snaps, grid, pts, valid, True)
        p, c = R.pso(keys[s:s + block], guess, dev, cost, int(pso_cfg["population"]),
                     int(pso_cfg["iterations"]))
        stencil = R.stencil_cost_fn(guess, snaps, grid, pts, valid, True)
        both = torch.stack([p, cand[s:s + block]], 1)  # [b, 2, 3]
        scores.append(stencil(both, None))
        poses.append(p)
        costs.append(c)
    pose = torch.cat(poses).cpu().numpy()
    cost = torch.cat(costs).cpu().numpy()
    sc = torch.cat(scores).cpu().numpy()
    n_valid = inputs["valid"][rows].sum(-1).clamp(min=1).cpu().numpy()
    dxy = np.hypot(cand_pose[:, 0] - pose[:, 0], cand_pose[:, 1] - pose[:, 1])
    dth = np.abs(cand_pose[:, 2] - pose[:, 2])
    dscore = np.abs(sc[:, 1] - sc[:, 0]) / n_valid
    dc = np.abs(cand_cost - cost) / n_valid
    p75 = lambda x: float(np.quantile(x, 0.75))
    numbers = {"pose_xy_p75_m": p75(dxy), "score_gap_p75": p75(dscore), "cost_gap_p75": p75(dc),
               "parted_pct": parted_pct(dxy, dth, parted)}
    witnesses = []
    if budgets is not None:
        for j in np.flatnonzero((dxy > parted["xy_m"]) | (dth > parted["th_rad"])):
            witnesses.append(_batch_witness(inputs, grid, pso_cfg, parted, rows[j:j + 1],
                                            keys[j:j + 1], budgets(int(j)), cand_pose[j],
                                            pose[j]))
    return {"numbers": numbers, "witnesses": witnesses,
            "samples": [(int(r), float(a), float(t), float(b), float(c))
                        for (r, _), a, t, b, c in zip(sampled, dxy, dth, dscore, dc)]}


def _pairs(inputs, r, dtype):
    get = lambda name: inputs[name][r].to(dtype) if inputs[name].is_floating_point() \
        else inputs[name][r]
    return ((get("mean"), get("icov"), get("built")), get("points"), get("valid"), get("guess"),
            get("dev"))


def _batch_witness(inputs, grid, pso_cfg, parted, row, key, prog, served, ref_pose) -> dict:
    """One parted batch sample: the reference again in float32, and the
    first iteration at which the program's global best parts from the
    float64 reference's, with both picks' float64 costs under the
    reference's binding pose there, the program's float32 cost of its pick,
    and the gap between the two float64 costs against the resolution (the
    program's cost of its pick less its float64 cost)."""
    f64, f32 = torch.float64, torch.float32
    pop, iters = int(pso_cfg["population"]), int(pso_cfg["iterations"])
    snaps, pts, valid, guess, dev = _pairs(inputs, row, f64)
    cost = R.frozen_cost_fn(guess, snaps, grid, pts, valid, True)
    track = []
    R.pso(key, guess, dev, cost, pop, iters, record=track)
    s32, p32, v32, g32, d32 = _pairs(inputs, row, f32)
    low, _ = R.pso(key, g32, d32, R.frozen_cost_fn(g32, s32, grid, p32, v32, True), pop, iters)
    low = low[0].to(f64).cpu().numpy()
    gap = lambda a, b: [float(np.hypot(a[0] - b[0], a[1] - b[1])), float(abs(a[2] - b[2]))]
    out = {"pool_row": int(row[0]), "served": np.asarray(served).tolist(),
           "f64": np.asarray(ref_pose).tolist(), "f32": low.tolist(),
           "f32_from_f64": gap(low, ref_pose), "f32_from_served": gap(low, served),
           "program_rerun_equals_served": bool(np.array_equal(np.asarray(prog[-1][0]), served))}
    for k in range(1, iters + 1):
        a = np.asarray(prog[k - 1][0], np.float64)
        b = track[k][0][0].cpu().numpy()
        dxy, dth = gap(a, b)
        if dxy <= parted["xy_m"] and dth <= parted["th_rad"]:
            continue
        bind = track[k - 1][0]
        at = lambda pose: torch.as_tensor(pose, dtype=f64, device=bind.device)[None, None]
        c = lambda pose: float(cost(at(pose), bind)[0, 0])
        ca, cb = c(a), c(b)
        out.update(iteration=k, program_pick=a.tolist(), reference_pick=b.tolist(),
                   f64_cost_program_pick=ca, f64_cost_reference_pick=cb,
                   program_cost=float(prog[k - 1][1]), gap=ca - cb,
                   resolution=abs(float(prog[k - 1][1]) - ca))
        break
    return out
