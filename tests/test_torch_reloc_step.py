"""The relocalization's refine swarms on the card (ops/reloc_step.py, the
CUDA kernel csrc/reloc_step.cu) against their plain version, the CPU branch
of models/slam.py:_refine_hypotheses (pso_solve_batch on the rebound frozen
cost).

On the CPU: the wrapper refuses CPU tensors, wrong shapes and wrong dtypes
and never falls back to the plain version; a fold refuses missing or
misplaced costs; the inertia it passes is
pso_solve_batch's running product; and the CPU branch of
_refine_hypotheses returns the bits it returned before the kernel, on the
window branch and on the whole-table branch.

The ``gpu`` tests (skipped here; on the card:
``python -m pytest --noconftest -m gpu tests/test_torch_reloc_step.py``)
drive the kernel launch by launch on tests/test_torch_recovery.py's kidnap
(the 48-cell map's whole table, and a 40-cell window), with K3's costs in
between, and hold:

* the draws to ``pso._batch_draws`` bit for bit, at the init and at each
  iteration (the positions and velocities they make, in pso_solve_batch's
  order of operations);
* each launch's mask to ``cost.bind_points_matmul_window`` /
  ``bind_points_matmul`` at the same global best bit for bit, and w and the
  features to ``_quadform_bound`` / ``pose_features_t`` within float32
  rounding (W_RTOL: the cancelling terms of BᵀΛB at 20 m; a point bound to
  a neighbouring cell moves its w by orders more, so equal w is equal cell
  indices);
* the state after each fold to pso_solve_batch fed the same costs, bit for
  bit, NaN costs included;
* a whole refine to the CPU path within the frozen-solve tolerance of
  test_torch_recovery.py, with 2 x (I + 2) launches of the kernel and of K3,
  and to the PyTorch path the card ran before the kernel (pso_solve_batch
  scored by K3) bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import pso as tpso
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.ops import reloc_step as treloc
from ndtpso_slam_tpu_torch.ops import rng as trng
from ndtpso_slam_tpu_torch.ops import score as tscore
from test_torch_recovery import KEY, _before_kidnap, cuda_device  # noqa: F401 (fixture)

# w of a point 20 m out: terms of ~1e3 that cancel to ~1 (BᵀΛB), so an ulp
# of a term is ~1e-4 of the result at worst; the features' products round
# once each.
W_RTOL, W_ATOL = 1e-5, 1e-5
PHI_RTOL, PHI_ATOL = 1e-6, 1e-7
# The window branch's side on the 48-cell fixture map.
WINDOW = 40


@pytest.fixture(scope="module")
def kidnap():
    """tests/test_torch_recovery.py's state before the kidnap's refine:
    (cfg, state, snap, scan, hypotheses)."""
    return _before_kidnap()


def _with_patch(cfg, ps):
    return dataclasses.replace(cfg, recovery=dataclasses.replace(cfg.recovery, patch_cells=ps))


def _seed_refine(key, snap, scan, last_pose, hypo, cfg, score=tcost.bound_cost):
    """_refine_hypotheses as it was before the kidnap's kernel: two
    pso_solve_batch calls on the window (or whole-table) binder scored by
    ``score`` (bound_cost, the CPU's; bound_cost_fused, K3, the card's),
    then the exact-cost winner."""
    rc = cfg.recovery
    dtype, dev = last_pose.dtype, last_pose.device
    k = hypo.shape[0]
    w_cells = cfg.map.cells_per_side
    ps = rc.patch_cells if 0 < rc.patch_cells < w_cells else 0
    if ps:
        origin = tcost.window_origin(last_pose, ps, cfg.map)

        def make_cost(tbl):
            patch = tcost.table_window(tbl, origin, ps, cfg.map)
            return lambda poses, binds: score(
                poses, tcost.bind_points_matmul_window(
                    binds, patch, origin, ps, scan.points, scan.valid, cfg.map))
    else:
        def make_cost(tbl):
            return lambda poses, binds: score(
                poses, tcost.bind_points_matmul(binds, tbl, scan.points, scan.valid, cfg.map))

    rk = trng.threefry2x32(key, 0x5EC0, 0xFA11)
    ids = torch.arange(k, dtype=torch.int64)
    swarm_keys = lambda c0, c1: torch.stack(trng.threefry2x32(rk, c0, c1), dim=-1)
    refine_snap = tmap.smooth_snapshot(snap, rc.refine_sigma) if rc.refine_sigma > 0 else snap
    expand = lambda v: torch.tensor(v, dtype=dtype).to(dev).expand(k, 3)
    refined = tpso.pso_solve_batch(
        swarm_keys(ids, torch.full_like(ids, 0x5117)), hypo, expand(rc.deviation),
        make_cost(tcost.snapshot_table(refine_snap)), rc.pso).pose
    polished = tpso.pso_solve_batch(
        swarm_keys(ids + 0x907, torch.full_like(ids, 0x13)), refined, expand((0.1, 0.1, 0.05)),
        make_cost(tcost.snapshot_table(snap)), rc.pso).pose
    final = tcost.ndt_cost(polished, snap, scan.points, scan.valid, cfg.map)
    best_cost, best_pose = tpso._select_min(final, polished)
    return best_pose.to(dtype), best_cost.to(dtype)


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("ps", [0, WINDOW])
def test_cpu_refine_is_the_seed_refine_bit_for_bit(kidnap, ps):
    """The CPU branch of _refine_hypotheses is the plain version the kernel
    is held to: the same bits as before the kernel, whole table and window."""
    cfg, state, snap, scan, hypo = kidnap
    cfg = _with_patch(cfg, ps)
    assert (0 < cfg.recovery.patch_cells < cfg.map.cells_per_side) == (ps == WINDOW)
    key = trng.derive_key(KEY, 8)
    pose, cost = tslam._refine_hypotheses(key, snap, scan, state.pose, hypo.clone(), cfg)
    want_pose, want_cost = _seed_refine(key, snap, scan, state.pose, hypo.clone(), cfg)
    assert torch.equal(pose, want_pose) and torch.equal(cost, want_cost)


def test_inertia_is_pso_solve_batch_running_product():
    """The inertia the host passes each iteration: pso_solve_batch's float32
    ``w = w * w_damping``, not a power."""
    cfg = tcfg.PSOConfig(iterations=40, population=8, w=0.8, w_damping=0.97)
    w, want = torch.tensor(cfg.w, dtype=torch.float32), []
    for _ in range(cfg.iterations):
        want.append(float(w))
        w = w * cfg.w_damping
    assert treloc.inertia(cfg) == want
    assert treloc.inertia(tcfg.RecoveryConfig().pso) == [float(np.float32(0.8))] * 20


def _args(b=2, n=16, mc=tcfg.MapConfig(size_m=8.0, cell_side_m=1.0), device="cpu"):
    """reloc_init's arguments at a tiny size."""
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return dict(keys=torch.zeros((b, 2), dtype=torch.int64), guesses=f(b, 3), deviation=(0.3,) * 3,
                tbl=f(mc.num_cells, 6), anchor=f(3), ps=0, points=f(n, 2),
                valid=torch.ones(n, dtype=torch.bool, device=device), map_cfg=mc,
                pso_cfg=tcfg.PSOConfig(iterations=2, population=4))


@pytest.mark.parametrize("entry", ["reloc_init", "refine_solve"])
def test_wrapper_refuses_cpu_tensors(entry):
    """CPU tensors are refused before the library loads: no fallback to the
    plain version."""
    before = treloc.reloc_step.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        getattr(treloc, entry)(**_args())
    assert treloc.reloc_step.LAUNCHES == before


@pytest.mark.parametrize("field,bad", [
    ("guesses", torch.zeros((2, 2))),
    ("anchor", torch.zeros(2)),
    ("tbl", torch.zeros((60, 6))),
    ("tbl", torch.zeros((64, 5))),
    ("points", torch.zeros((16, 3))),
    ("valid", torch.ones(15, dtype=torch.bool)),
    ("guesses", torch.zeros((0, 3))),
])
def test_wrapper_refuses_wrong_shapes(field, bad):
    with pytest.raises(ValueError):
        treloc.reloc_init(**{**_args(), field: bad})


@pytest.mark.parametrize("field,bad", [
    ("guesses", torch.zeros((2, 3), dtype=torch.float64)),
    ("anchor", torch.zeros(3, dtype=torch.float16)),
    ("tbl", torch.zeros((64, 6), dtype=torch.float64)),
    ("points", torch.zeros((16, 2), dtype=torch.bfloat16)),
    ("valid", torch.ones(16, dtype=torch.uint8)),
])
def test_wrapper_refuses_wrong_dtypes(field, bad):
    with pytest.raises(TypeError):
        treloc.reloc_init(**{**_args(), field: bad})


def _swarms(folds=0, done=False):
    """Swarms of _args()'s size as they stand after ``folds`` folds, built
    without a launch."""
    a = _args()
    b, p, n = 2, a["pso_cfg"].population, 16
    f = lambda *s: torch.zeros(s, dtype=torch.float32)
    return treloc.Swarms(
        state=f(b, treloc.state_floats(p)), keys=a["keys"].to(torch.int32), guesses=a["guesses"],
        anchor=a["anchor"], tbl=a["tbl"], points=a["points"], valid=a["valid"],
        phit_seed=f(b, treloc.FEATURES, 1), phit=f(b, treloc.FEATURES, p),
        w=f(b, n, treloc.FEATURES), mask=f(b, n), pose=f(b, 3), cost=f(b), ps=0,
        map_cfg=a["map_cfg"], pso_cfg=a["pso_cfg"], deviation=a["deviation"],
        inertia=treloc.inertia(a["pso_cfg"]), folds=folds, done=done)


@pytest.mark.parametrize("case,match", [
    ("step_without_costs", "population's costs"),
    ("final_without_costs", "population's costs"),
    ("first_fold_without_seeds", "first fold"),
    ("later_fold_with_seeds", "first fold"),
    ("after_the_final", "final launch"),
    ("iteration_out_of_range", "iteration"),
    ("costs_of_the_wrong_shape", "expected contiguous"),
])
def test_folds_refuse_missing_or_misplaced_costs(case, match):
    """A fold without the population's costs, the seeds' costs missing at
    the first fold or given at a later one, a launch after the final, an
    iteration past the last, or costs of the wrong shape are refused before
    the library loads."""
    cost, seed = torch.zeros((2, 4)), torch.zeros((2, 1))
    calls = {
        "step_without_costs": lambda: treloc.reloc_step(_swarms(), 0, None, seed),
        "final_without_costs": lambda: treloc.reloc_final(_swarms(1), None),
        "first_fold_without_seeds": lambda: treloc.reloc_step(_swarms(), 0, cost),
        "later_fold_with_seeds": lambda: treloc.reloc_final(_swarms(2), cost, seed),
        "after_the_final": lambda: treloc.reloc_final(_swarms(3, done=True), cost),
        "iteration_out_of_range": lambda: treloc.reloc_step(_swarms(1), 2, cost),
        "costs_of_the_wrong_shape": lambda: treloc.reloc_step(_swarms(1), 1, cost[:, :3]),
    }
    before = treloc.reloc_step.LAUNCHES
    with pytest.raises(ValueError, match=match):
        calls[case]()
    assert treloc.reloc_step.LAUNCHES == before


def test_wrapper_refuses_non_contiguous_and_bad_window():
    args = _args()
    with pytest.raises(ValueError, match="contiguous"):
        treloc.reloc_init(**{**args, "guesses": torch.zeros((3, 2)).t()})
    with pytest.raises(ValueError, match="window"):
        treloc.reloc_init(**{**args, "ps": 9})


# ------------------------------------------------------------ on the card


def _gpu_world(kidnap, dev, ps):
    """The refine's first solve on the card: (cfg, keys [K, 2], hypotheses,
    the refine table, the anchor, the window side, the scan)."""
    cfg, state, snap, scan, hypo = kidnap
    cfg = _with_patch(cfg, ps)
    rc = cfg.recovery
    to = lambda t: t.to(dev)
    rk = trng.threefry2x32(trng.derive_key(KEY, 8), 0x5EC0, 0xFA11)
    ids = torch.arange(hypo.shape[0], dtype=torch.int64)
    keys = torch.stack(trng.threefry2x32(rk, ids, torch.full_like(ids, 0x5117)), dim=-1)
    tbl = tcost.snapshot_table(tmap.smooth_snapshot(snap, rc.refine_sigma))
    gscan = tscan.Scan(points=to(scan.points), valid=to(scan.valid))
    w_cells = cfg.map.cells_per_side
    side = rc.patch_cells if 0 < rc.patch_cells < w_cells else 0
    return cfg, keys, to(hypo), to(tbl), to(state.pose), side, gscan


def _unpack(state, p):
    """(pos, vel, pbest [B, P, 3], pbest_cost [B, P], gbest [B, 3],
    gbest_cost [B]) of the kernel's state buffer."""
    b = state.shape[0]
    part = lambda k: state[:, 3 * k * p:3 * (k + 1) * p].reshape(b, 3, p).transpose(1, 2)
    return part(0), part(1), part(2), state[:, 9 * p:10 * p], state[:, 10 * p:10 * p + 3], \
        state[:, 10 * p + 3]


def _run_launches(world, cost_hook=None):
    """The solve launch by launch, K3 in between.  cost_hook(e, cost) may
    replace evaluation e's costs (e = 0 the seeds, 1 the population, 2 + i
    iteration i).  Returns the swarms and one record per launch: (state,
    phit_seed, phit, w, mask) after it, and the costs of each evaluation."""
    cfg, keys, hypo, tbl, anchor, ps, scan = world
    rc = cfg.recovery
    sw = treloc.reloc_init(keys, hypo, rc.deviation, tbl, anchor, ps, scan.points, scan.valid,
                           cfg.map, rc.pso)
    snap = lambda: tuple(t.clone() for t in (sw.state, sw.phit_seed, sw.phit, sw.w, sw.mask))
    hook = cost_hook or (lambda e, c: c)
    records, costs = [snap()], []

    def score(e, phit):
        costs.append(hook(e, tscore.fused_bound_scores(phit, sw.w, sw.mask)).contiguous())
        return costs[-1]

    seed, cost = score(0, sw.phit_seed), score(1, sw.phit)
    for i in range(rc.pso.iterations):
        treloc.reloc_step(sw, i, cost, seed if i == 0 else None)
        records.append(snap())
        cost = score(2 + i, sw.phit)
    treloc.reloc_final(sw, cost, seed if rc.pso.iterations == 0 else None)
    records.append(snap())
    torch.cuda.synchronize()
    return sw, records, costs


def _reference_solve(world, costs):
    """pso_solve_batch on the card fed evaluation e's costs ``costs[e]``:
    (its result, the (poses, binds) of each evaluation)."""
    cfg, keys, hypo, tbl, anchor, ps, scan = world
    rc = cfg.recovery
    seen = []

    def cost_fn(poses, binds):
        seen.append((poses.clone(), binds.clone()))
        return costs[len(seen) - 1]

    devs = torch.tensor(rc.deviation, dtype=torch.float32).to(hypo.device).expand(len(hypo), 3)
    return tpso.pso_solve_batch(keys, hypo, devs, cost_fn, rc.pso), seen


def _reference_bind(world, bind_pose):
    cfg, keys, hypo, tbl, anchor, ps, scan = world
    if ps:
        origin = tcost.window_origin(anchor, ps, cfg.map)
        patch = tcost.table_window(tbl, origin, ps, cfg.map)
        return tcost.bind_points_matmul_window(bind_pose, patch, origin, ps, scan.points,
                                               scan.valid, cfg.map)
    return tcost.bind_points_matmul(bind_pose, tbl, scan.points, scan.valid, cfg.map)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [0, WINDOW])
def test_draws_bit_for_bit_with_batch_draws(kidnap, cuda_device, ps):
    """The init's positions and seeds from _batch_draws' u_p and u_g, and
    each iteration's velocity from its r1, r2, in pso_solve_batch's order of
    operations: bit for bit."""
    world = _gpu_world(kidnap, cuda_device, ps)
    cfg, keys, hypo, *_ = world
    rc, p = cfg.recovery, cfg.recovery.pso.population
    sw, records, _ = _run_launches(world)
    kw = (keys.to(cuda_device) & 0xFFFFFFFF)
    u_g, u_p = tpso._batch_draws(kw, None, p, torch.float32, cuda_device, "threefry")
    f32 = lambda v: torch.tensor(v, dtype=torch.float32).to(cuda_device)
    pos0, vel0, _, _, gb0, _ = _unpack(records[0][0], p)
    assert torch.equal(pos0, hypo[:, None, :] + (2.0 * u_p - 1.0) * f32(rc.deviation)[None, None])
    assert torch.equal(gb0, hypo + (2.0 * u_g - 1.0) * f32(tcfg.ZERO_DEVIATION))
    assert (vel0 == 0).all()
    w = f32(rc.pso.w)
    for i in range(rc.pso.iterations):
        pos, vel, *_ = _unpack(records[i][0], p)
        n_pos, n_vel, pbest, _, gbest, _ = _unpack(records[i + 1][0], p)
        r1, r2 = tpso._batch_draws(kw, i, p, torch.float32, cuda_device, "threefry")
        want = w * vel + rc.pso.c1 * r1 * (pbest - pos) + rc.pso.c2 * r2 * (gbest[:, None] - pos)
        assert torch.equal(n_vel, want), i
        assert torch.equal(n_pos, pos + want), i
        w = w * rc.pso.w_damping


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [0, WINDOW])
def test_each_launch_binds_as_the_pytorch_binder(kidnap, cuda_device, ps):
    """Every launch's mask bit for bit with the PyTorch binder at the same
    global best, w within float32 rounding of _quadform_bound's (equal cell
    indices), and the features within rounding of pose_features_t's."""
    world = _gpu_world(kidnap, cuda_device, ps)
    cfg, keys, hypo, *_ = world
    p = cfg.recovery.pso.population
    _, records, _ = _run_launches(world)
    masked = []
    for e, (state, phit_seed, phit, w, mask) in enumerate(records[:-1]):
        pos, _, _, _, gbest, _ = _unpack(state, p)
        bind_pose = hypo if e == 0 else gbest
        ref = _reference_bind(world, bind_pose)
        assert torch.equal(mask, ref.mask), e
        torch.testing.assert_close(w, ref.w, rtol=W_RTOL, atol=W_ATOL)
        assert (w[mask == 0] == 0).all()
        torch.testing.assert_close(phit, tcost.pose_features_t(pos, bind_pose), rtol=PHI_RTOL,
                                   atol=PHI_ATOL)
        if e == 0:
            torch.testing.assert_close(phit_seed, tcost.pose_features_t(gbest[:, None], hypo),
                                       rtol=PHI_RTOL, atol=PHI_ATOL)
        masked.append(int((mask == 0).sum()))
    assert sum(masked) > 0 and max(masked) < mask.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [0, WINDOW])
def test_state_after_each_fold_is_pso_solve_batch(kidnap, cuda_device, ps):
    """pso_solve_batch on the card, fed the costs K3 gave the kernel's run:
    the poses it scores and the global best it binds at each evaluation,
    and its result, equal the kernel's state bit for bit."""
    world = _gpu_world(kidnap, cuda_device, ps)
    p = world[0].recovery.pso.population
    sw, records, costs = _run_launches(world)
    res, seen = _reference_solve(world, costs)
    assert len(seen) == len(costs) == len(records)
    pos0, _, _, _, gb0, _ = _unpack(records[0][0], p)
    assert torch.equal(seen[0][0][:, 0], gb0) and torch.equal(seen[1][0], pos0)
    for i in range(len(records) - 2):
        pos, _, _, _, gbest, _ = _unpack(records[i + 1][0], p)
        assert torch.equal(seen[i + 2][0], pos), i
        assert torch.equal(seen[i + 2][1], gbest), i
    assert torch.equal(sw.pose, res.pose) and torch.equal(sw.cost, res.cost)


@pytest.mark.gpu
def test_nan_never_wins(kidnap, cuda_device):
    """NaN in the table's unbuilt cells (the degenerate lanes a bind masks)
    reaches neither w nor the costs.  NaN costs planted on the particles
    that would win an iteration's fold never become a personal or global
    best; one planted in swarm 0's initial population makes its minimum NaN
    at every later fold, so that swarm keeps its seed, as pso_solve_batch
    does.  The state equals pso_solve_batch's fed the same costs."""
    cfg, keys, hypo, tbl, anchor, ps, scan = _gpu_world(kidnap, cuda_device, WINDOW)
    tbl = tbl.clone()
    tbl[tbl[:, 5] < 0.5, :5] = float("nan")
    world = (cfg, keys, hypo, tbl, anchor, ps, scan)
    p = cfg.recovery.pso.population
    rows = torch.arange(len(hypo), device=cuda_device)

    def plant(e, cost):
        assert torch.isfinite(cost).all(), e
        cost = cost.clone()
        if e == 1:
            cost[0, cost[0].argmin()] = float("nan")
        elif e in (4, 9):
            cost[rows, cost.argmin(dim=1)] = float("nan")
        return cost

    sw, records, costs = _run_launches(world, plant)
    assert all(torch.isfinite(r[3]).all() for r in records[:-1])
    res, seen = _reference_solve(world, costs)
    for i in range(len(records) - 2):
        pos, _, pbest, pbest_cost, gbest, _ = _unpack(records[i + 1][0], p)
        assert torch.equal(seen[i + 2][0], pos) and torch.equal(seen[i + 2][1], gbest), i
        assert not torch.isnan(pbest_cost[1:]).any(), i
    assert torch.equal(sw.pose, res.pose) and torch.equal(sw.cost, res.cost)
    assert torch.equal(sw.pose[0], _unpack(records[0][0], p)[4][0])
    assert torch.isfinite(sw.pose).all() and torch.isfinite(sw.cost).all()


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [0, WINDOW])
def test_whole_refine_lands_with_the_cpu_path(kidnap, cuda_device, ps):
    """_refine_hypotheses on the card: 2 x (I + 2) launches of the kernel and
    of K3, the winner where the CPU path's lands (5e-3; cost rtol 1e-4)."""
    cfg, state, snap, scan, hypo = kidnap
    cfg = _with_patch(cfg, ps)
    key = trng.derive_key(KEY, 8)
    want_pose, want_cost = tslam._refine_hypotheses(key, snap, scan, state.pose, hypo.clone(), cfg)
    to = lambda t: t.to(cuda_device)
    gsnap = tmap.MapSnapshot(to(snap.mean), to(snap.inv_cov), to(snap.built))
    gscan = tscan.Scan(points=to(scan.points), valid=to(scan.valid))
    k3, kern = tscore.fused_bound_scores.LAUNCHES, treloc.reloc_step.LAUNCHES
    pose, cost = tslam._refine_hypotheses(key, gsnap, gscan, to(state.pose), to(hypo), cfg)
    torch.cuda.synchronize()
    evals = 2 * (cfg.recovery.pso.iterations + 2)
    assert tscore.fused_bound_scores.LAUNCHES - k3 == evals
    assert treloc.reloc_step.LAUNCHES - kern == evals
    np.testing.assert_allclose(pose.cpu().numpy(), want_pose.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [0, WINDOW])
def test_whole_refine_equals_the_pytorch_path_on_the_card(kidnap, cuda_device, ps):
    """The kernel's refine and the PyTorch path the card ran before it
    (pso_solve_batch on the PyTorch binder, scored by K3) give the same
    pose and cost bit for bit: the same operands reach the same K3."""
    cfg, state, snap, scan, hypo = kidnap
    cfg = _with_patch(cfg, ps)
    key = trng.derive_key(KEY, 8)
    to = lambda t: t.to(cuda_device)
    gsnap = tmap.MapSnapshot(to(snap.mean), to(snap.inv_cov), to(snap.built))
    gscan = tscan.Scan(points=to(scan.points), valid=to(scan.valid))
    pose, cost = tslam._refine_hypotheses(key, gsnap, gscan, to(state.pose), to(hypo), cfg)
    want_pose, want_cost = _seed_refine(key, gsnap, gscan, to(state.pose), to(hypo), cfg,
                                        tcost.bound_cost_fused)
    assert torch.equal(pose, want_pose) and torch.equal(cost, want_cost)
