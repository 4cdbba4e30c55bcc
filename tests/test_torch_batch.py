"""The port's batch scan matching against the JAX package, on the CPU: the
frozen rollout kernel's module (ops/rollout.py) and solve_batch in every
cost mode.

On the CPU every wrapper runs its plain PyTorch version; the JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Tolerances are the JAX package's own (tests/test_rollout.py,
tests/test_parallel.py):

* per-particle exact solves (exact, local_exact, rollout_local): costs and
  poses 1e-5 — float associativity and the ulps of sin/cos/exp;
* frozen-correspondence solves (fast*, rollout): costs rtol 1e-4 / atol 1e-3,
  poses atol 5e-3 — the [P, N] matrix products and point sums run in other
  orders, and a PSO decision between nearly equal particles may flip;
* bf16 scoring: costs rtol 2e-2, poses 5e-2 against f32 — one bf16 rounding
  of each operand;
* turbo modes (Philox draws, not the TPU's hardware stream): accuracy gates
  only, as the JAX package's turbo tests.

K2 runs one solve per thread-block cluster of C CTAs and sums each cost
over a CTA's points, then over the CTAs in rank order; the chooser of C and
that sum order (``packed_frozen_cost(cluster=C)``), and the most particles
one K2 launch takes, are held here.  The kernels themselves run only on a
GPU: the ``gpu``-marked tests compare each with its plain version there,
summed in the order of the kernel's cluster (K2 and K1's turbo branch at
every C, on ragged point counts, small batches and the early exit), and
skip here.  The GPU machine has no
JAX, so run them there with
``python -m pytest --noconftest -m gpu tests/test_torch_batch.py``.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.models import solve as tsolve
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops import rollout as tro
from ndtpso_slam_tpu_torch.ops import rollout_local as trl
from ndtpso_slam_tpu_torch.ops import score as tscore
from ndtpso_slam_tpu_torch.parallel import mesh as tmesh
from ndtpso_slam_tpu_torch.utils.state import snapshot_from_numpy

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import cost as jcost
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.ops import pallas_rollout as jpr
    from ndtpso_slam_tpu.parallel import mesh as jmesh

    JMAP = jcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")

TMAP = tcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
N_PAD = 256
B = 3
# A known SE(2) offset: query points are the map's points seen from TRUE, so
# the solve should return its inverse (tests/test_rollout.py).
TRUE = np.float32([0.15, -0.1, 0.04])
_c, _s = np.cos(TRUE[2]), np.sin(TRUE[2])
INV = np.float32([-(TRUE[0] * _c + TRUE[1] * _s), TRUE[0] * _s - TRUE[1] * _c, -TRUE[2]])


@pytest.fixture(scope="module")
def world():
    """The JAX package's rollout test world (an ellipse of 200 points mapped
    twice; built by the port, which matches the JAX map bit for bit on the
    CPU) and a batch of B solves, all as numpy arrays."""
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))).astype(np.float32)
    state = tmap.init_map(TMAP, device="cpu")
    for _ in range(2):
        noisy = pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)
        tmap.add_points(state, TMAP, torch.from_numpy(noisy), torch.ones(200, dtype=torch.bool))
        tmap.build(state, TMAP)
    ts = tmap.snapshot(state, TMAP)
    snap = dict(mean=ts.mean.numpy(), inv_cov=ts.inv_cov.numpy(), built=ts.built.numpy())
    rs = np.random.RandomState(1)
    keys = rs.randint(0, 2**31, (B, 2)).astype(np.uint32)
    guesses = rs.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    devs = np.tile(np.float32([0.2, 0.2, 0.05]), (B, 1))
    points = np.zeros((B, N_PAD, 2), np.float32)
    points[:, :200] = pts[None]
    valid = np.zeros((B, N_PAD), bool)
    valid[:, :200] = True
    snaps = {k: np.stack([v] * B) for k, v in snap.items()}
    return dict(snap=snap, snaps=snaps, pts=pts, keys=keys, guesses=guesses, devs=devs,
                points=points, valid=valid)


def _targs(world, points=None, device="cpu"):
    """solve_batch arguments for the port."""
    points = world["points"] if points is None else points
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return (t(world["keys"].astype(np.int64)), t(world["guesses"]), t(world["devs"]),
            snapshot_from_numpy(world["snaps"], device), t(points), t(world["valid"]))


def _jargs(world, points=None):
    points = world["points"] if points is None else points
    snaps = jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in world["snaps"].items()})
    return (world["keys"], world["guesses"], world["devs"], snaps, points, world["valid"])


def _moved_points(world):
    """The map's points seen from TRUE, padded like world['points']."""
    pts = world["pts"]
    moved = np.stack([pts[:, 0] * _c - pts[:, 1] * _s + TRUE[0],
                      pts[:, 0] * _s + pts[:, 1] * _c + TRUE[1]], -1).astype(np.float32)
    out = world["points"].copy()
    out[:, :200] = moved[None]
    return out


def _port_packed(world, device="cpu"):
    keys, guesses, devs, snaps, points, valid = _targs(world, device=device)
    nbr = tcost.bind_neighborhood(guesses, snaps, points, valid, TMAP)
    return tro.pack_rollout_inputs(nbr, points)


@pytest.fixture(scope="module")
def jpacked(world):
    """The JAX package's packed rollout inputs of the world's batch."""
    keys, guesses, devs, snaps, points, valid = _jargs(world)

    @jax.jit  # one XLA compile, where op-by-op dispatch would compile every op
    def pack(g, s, p, v):
        nbrs = jax.vmap(lambda g, s, p, v: jcost.bind_neighborhood(g, s, p, v, JMAP, radius=2))(
            g, s, p, v)
        return jax.vmap(jpr.pack_rollout_inputs)(nbrs, p)

    return pack(jnp.asarray(guesses), snaps, jnp.asarray(points), jnp.asarray(valid))


# ---------------------------------------------------------------- packing


@needs_jax
def test_pack_matches_jax_on_built_lanes(world, jpacked):
    """The layouts are the JAX package's; the port zeroes the statistics of
    unbuilt lanes, which the JAX packer leaves as they were gathered."""
    tsten, tpts = _port_packed(world)
    jsten, jpts = (np.asarray(a) for a in jpacked)
    assert tsten.shape == (B, 25, 8, N_PAD) and tpts.shape == (B, 8, N_PAD)
    np.testing.assert_array_equal(tpts.numpy(), jpts)
    built = jsten[:, :, 5:6, :] > 0
    np.testing.assert_array_equal(tsten[:, :, 5].numpy(), jsten[:, :, 5])
    np.testing.assert_array_equal(np.where(built, jsten, 0.0), tsten.numpy())
    assert built.any() and (~built).any()


def test_pack_batched_equals_per_solve(world):
    sten, pts = _port_packed(world)
    keys, guesses, devs, snaps, points, valid = _targs(world)
    for b in range(B):
        snap = tmap.MapSnapshot(mean=snaps.mean[b], inv_cov=snaps.inv_cov[b], built=snaps.built[b])
        s1, p1 = tro.pack_rollout_inputs(
            tcost.bind_neighborhood(guesses[b], snap, points[b], valid[b], TMAP), points[b])
        np.testing.assert_array_equal(sten[b].numpy(), s1.numpy())
        np.testing.assert_array_equal(pts[b].numpy(), p1.numpy())


# ------------------------------------------- K2's plain version vs the JAX kernel


def _rollout_both(world, jpacked, population, iterations=10, **kw):
    cfg_j = jcfg.PSOConfig(iterations=iterations, population=population)
    cfg_t = tcfg.PSOConfig(iterations=iterations, population=population)
    jsten, jpts = jpacked
    jp, jc = jpr.pso_rollout(world["keys"], world["guesses"], world["devs"], jsten, jpts,
                             cfg_j, JMAP, interpret=True, **kw)
    sten, pts = _port_packed(world)
    keys, guesses, devs = _targs(world)[:3]
    before = tro.pso_rollout.LAUNCHES
    tp, tc = tro.pso_rollout(keys, guesses, devs, sten, pts, cfg_t, TMAP, **kw)
    assert tro.pso_rollout.LAUNCHES == before  # CPU tensors never launch
    return (tp.numpy(), tc.numpy()), (np.asarray(jp), np.asarray(jc))


@needs_jax
@pytest.mark.parametrize("population,iterations,kw", [
    (200, 10, dict()),
    (50, 12, dict(exp_mode="exp2", early_exit=2)),
    (50, 10, dict(exp_mode="approx")),
], ids=["p200", "exp2-early-exit", "approx"])
def test_plain_rollout_matches_jax_kernel(world, jpacked, population, iterations, kw):
    """Each branch of K2's plain version on the Threefry stream against the
    JAX kernel: two lane tiles of particles; the exp2 form with the early
    exit; the Schraudolph form.  (One JAX compile each; P=64 with exp at
    the fixed budget is solve_batch's rollout case.)"""
    (tp, tc), (jp, jc) = _rollout_both(world, jpacked, population, iterations, **kw)
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tp, jp, atol=5e-3)


def test_plain_rollout_bf16_close_to_f32(world):
    """bf16 operands perturb the cost by O(0.4%) but land in the same basin
    (same draws); the JAX comparison is solve_batch's rollout_bf16 case."""
    sten, pts = _port_packed(world)
    args = (*_targs(world)[:3], sten, pts, tcfg.PSOConfig(iterations=10, population=128), TMAP)
    fp, fc = tro.pso_rollout(*args)
    bp, bc = tro.pso_rollout(*args, score_dtype="bf16")
    assert not np.array_equal(fc.numpy(), bc.numpy())
    np.testing.assert_allclose(bc.numpy(), fc.numpy(), rtol=2e-2)
    np.testing.assert_allclose(bp.numpy(), fp.numpy(), atol=5e-2)


def test_early_exit_at_budget_is_the_fixed_budget(world):
    """early_exit >= iterations never trips: bitwise the fixed budget; a
    tight early exit can only end the same or worse."""
    sten, pts = _port_packed(world)
    keys, guesses, devs = _targs(world)[:3]
    cfg = tcfg.PSOConfig(iterations=8, population=64)
    p0, c0 = tro.pso_rollout(keys, guesses, devs, sten, pts, cfg, TMAP)
    p1, c1 = tro.pso_rollout(keys, guesses, devs, sten, pts, cfg, TMAP, early_exit=8)
    np.testing.assert_array_equal(p0.numpy(), p1.numpy())
    np.testing.assert_array_equal(c0.numpy(), c1.numpy())
    _, c2 = tro.pso_rollout(keys, guesses, devs, sten, pts, cfg, TMAP, early_exit=1)
    assert (c2.numpy() >= c0.numpy() - 1e-6).all()


def test_degenerate_unbuilt_lane_cannot_poison_the_cost(world):
    """An unbuilt stencil lane whose inverse covariance is inf (a degenerate
    cell) is zeroed by the packer, so the plain version's cost stays finite.
    The JAX packer keeps the inf and its kernel's one-hot select multiplies
    it by 0 (ROADMAP, queue 3)."""
    keys, guesses, devs, snaps, points, valid = _targs(world)
    nbr = tcost.bind_neighborhood(guesses, snaps, points, valid, TMAP)
    unbuilt = ~nbr.built
    assert unbuilt[0, :200].any()
    nbr.icov = torch.where(unbuilt[..., None], torch.tensor(float("inf")), nbr.icov)
    nbr.mean = torch.where(unbuilt[..., None], torch.tensor(float("nan")), nbr.mean)
    sten, pts = tro.pack_rollout_inputs(nbr, points)
    assert torch.isfinite(sten).all()
    cost = tro.packed_frozen_cost(
        guesses[:, None, :] + torch.tensor([[[0.0, 0.0, 0.0], [0.3, -0.2, 0.05]]]),
        guesses, sten, pts, TMAP)
    assert torch.isfinite(cost).all() and (cost < 0).all()
    _, c = tro.pso_rollout(keys, guesses, devs, sten, pts, tcfg.PSOConfig(iterations=4, population=32), TMAP)
    assert torch.isfinite(c).all()


# --------------------------------------------------- solve_batch, every mode

# (cost rtol, cost atol, pose atol) against the JAX solve of the same mode.
_EXACT = (1e-5, 1e-5, 1e-5)
_FROZEN = (1e-4, 1e-3, 5e-3)
_TOL = {
    "exact": _EXACT, "local_exact": _EXACT, "rollout_local": _EXACT,
    "fast": _FROZEN, "fast_local": _FROZEN, "fast_matmul": _FROZEN,
    "fast_fused": _FROZEN, "fast_local_fused": _FROZEN, "rollout": _FROZEN,
    "rollout_bf16": (2e-2, 0.0, 5e-2),
}
_TURBO = ("rollout_turbo", "rollout_turbo_bf16", "rollout_local_turbo")


def test_cost_modes_are_the_jax_modes():
    assert set(_TOL) | set(_TURBO) == set(tmesh.COST_MODES) == set(tsolve.MODES)
    if jax is not None:
        assert tmesh.COST_MODES == jmesh.COST_MODES


@needs_jax
@pytest.mark.parametrize("mode", sorted(_TOL))
def test_solve_batch_matches_jax(world, mode):
    cfg_j = jcfg.PSOConfig(iterations=8, population=64)
    cfg_t = tcfg.PSOConfig(iterations=8, population=64)
    ref = jmesh.solve_batch(*_jargs(world), JMAP, cfg_j, mode)
    got = tmesh.solve_batch(*_targs(world), TMAP, cfg_t, mode)
    assert got.pose.shape == (B, 3) and got.cost.shape == (B,)
    rtol, atol, patol = _TOL[mode]
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=patol)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_solve_batch_glir_matches_jax(world, mode):
    """solve_batch(optimizer="glir") at B = 3 against the JAX package's, in
    a plain cost mode of each kind: each solve is a GLIR-PSO solve of its
    own, held to the mode's tolerance; the rollout and fused modes refuse
    GLIR with the JAX package's ValueError."""
    cfg_j = jcfg.PSOConfig(iterations=8, population=64)
    cfg_t = tcfg.PSOConfig(iterations=8, population=64)
    ref = jmesh.solve_batch(*_jargs(world), JMAP, cfg_j, mode, optimizer="glir")
    got = tmesh.solve_batch(*_targs(world), TMAP, cfg_t, mode, optimizer="glir")
    rtol, atol, patol = _TOL[mode]
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=patol)
    for refused in ("rollout_local", "fast_fused"):
        with pytest.raises(ValueError, match="glir"):
            tmesh.solve_batch(*_targs(world), TMAP, cfg_t, refused, optimizer="glir")


@pytest.mark.parametrize("mode", _TURBO)
def test_turbo_modes_converge_to_truth(world, mode):
    """Turbo modes draw from Philox, not the TPU's stream: held to the JAX
    package's accuracy gates (tests/test_rollout.py:266, :385)."""
    cfg = tcfg.PSOConfig(iterations=20, population=256)
    res = tmesh.solve_batch(*_targs(world, _moved_points(world)), TMAP, cfg, mode)
    pose = res.pose.numpy()
    assert np.abs(pose[:, :2] - INV[None, :2]).max() < 0.05
    assert np.abs(pose[:, 2] - INV[2]).max() < 0.02
    assert np.isfinite(res.cost.numpy()).all()


def test_solve_batch_forwards_early_exit(world):
    """early_exit reaches the rollout kernels: the batch equals a direct call
    with the same K, and a tight K changes the result."""
    cfg = tcfg.PSOConfig(iterations=12, population=64)
    args = _targs(world)
    sten, pts = _port_packed(world)
    r1 = tmesh.solve_batch(*args, TMAP, cfg, "rollout", early_exit=1)
    pd, cd = tro.pso_rollout(*args[:3], sten, pts, cfg, TMAP, early_exit=1)
    np.testing.assert_array_equal(r1.pose.numpy(), pd.numpy())
    np.testing.assert_array_equal(r1.cost.numpy(), cd.numpy())
    r0 = tmesh.solve_batch(*args, TMAP, cfg, "rollout")
    assert not np.array_equal(r1.cost.numpy(), r0.cost.numpy())


@pytest.mark.parametrize("mode", ["rollout", "rollout_turbo_bf16", "rollout_local"])
def test_slam_align_is_a_solve_batch_of_one(world, mode):
    """The SLAM align's solve (one shared snapshot) and solve_batch's (a
    stacked one) go through the same dispatch and give the same bits."""
    keys, guesses, devs, snaps, points, valid = _targs(world)
    cfg = tcfg.PSOConfig(iterations=6, population=48)
    one_snap = tmap.MapSnapshot(mean=snaps.mean[:1], inv_cov=snaps.inv_cov[:1], built=snaps.built[:1])
    batch = tmesh.solve_batch(keys[:1], guesses[:1], devs[:1], one_snap, points[:1], valid[:1],
                              TMAP, cfg, mode)
    scfg = tcfg.SlamConfig(pso=cfg, map=TMAP, scan=tcfg.ScanConfig(max_beams=N_PAD), cost_mode=mode)
    snap = tmap.MapSnapshot(mean=snaps.mean[0], inv_cov=snaps.inv_cov[0], built=snaps.built[0])
    one = tslam._align_rollout((int(keys[0, 0]), int(keys[0, 1])), guesses[0], devs[0], snap,
                               tscan.Scan(points=points[0], valid=valid[0]), scfg)
    np.testing.assert_array_equal(one.pose.numpy(), batch.pose[0].numpy())
    np.testing.assert_array_equal(one.cost.numpy(), batch.cost[0].numpy())
    with pytest.raises(ValueError, match="not a rollout cost mode"):
        tsolve.solve_rollout_mode("fast", keys, guesses, devs, snaps, points, valid, TMAP, cfg)


def test_solve_batch_rejects_unknown_and_unported(world):
    args = _targs(world)
    cfg = tcfg.PSOConfig(iterations=2, population=8)
    with pytest.raises(ValueError, match="unknown cost_mode"):
        tmesh.solve_batch(*args, TMAP, cfg, "rollout_brf16")
    # The sharded solver, formerly unported (E1): the same refusal, and at
    # world 1 the sharded call is solve_batch.
    mesh = tmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="unknown cost_mode"):
        tmesh.make_sharded_solver(mesh, TMAP, cfg, "rollout_brf16")
    with pytest.raises(ValueError, match="shared_map=True"):
        tmesh.make_sharded_solver(mesh, TMAP, cfg, shared_map=True)(*args)
    got = tmesh.solve_batch_sharded(mesh, *args, TMAP, cfg)
    ref = tmesh.solve_batch(*args, TMAP, cfg)
    assert torch.equal(got.pose, ref.pose) and torch.equal(got.cost, ref.cost)


@needs_jax
@pytest.mark.parametrize("which", ["node", "batch"])
def test_mode_table_holds_the_jax_packages_modes(which):
    """The one table of cost modes (models/solve.py:MODES): its node modes
    are the JAX package's SLAM_COST_MODES, in their order (the CLI's
    choices), and all its modes the JAX package's batch COST_MODES; the
    port's public lists are views of it."""
    from ndtpso_slam_tpu.models import slam as jslam

    if which == "node":
        assert tsolve.NODE_MODES == jslam.SLAM_COST_MODES == tslam.SLAM_COST_MODES
        assert all(tsolve.MODES[m].node for m in jslam.SLAM_COST_MODES)
    else:
        assert frozenset(tsolve.MODES) == jmesh.COST_MODES == tmesh.COST_MODES


# (cost mode, optimizer, the match) of each refusal: an unknown mode, and
# GLIR-PSO with a whole-solve kernel's mode.
_REFUSED = {"unknown": ("rollout_brf16", "pso", "unknown cost_mode"),
            "glir": ("rollout_local", "glir", "glir")}


@pytest.mark.parametrize("site,case", [
    (site, case)
    for site in ("validate_config", "solve_batch", "make_sharded_solver", "check_fleet_cfg")
    for case in _REFUSED
    if (site, case) != ("make_sharded_solver", "glir")  # the sharded solver runs PSO only
])
def test_every_entry_refuses_a_mode_alike(world, site, case):
    """The SLAM config, solve_batch, the sharded solver and the flat fleet
    refuse an unknown mode and GLIR with a kernel mode through the one
    check, with its text (the node's modes for the node's entries)."""
    from ndtpso_slam_tpu_torch.parallel import fleet as tfleet

    mode, optimizer, match = _REFUSED[case]
    cfg = tcfg.PSOConfig(iterations=2, population=8)
    scfg = tcfg.SlamConfig(pso=cfg, map=TMAP, cost_mode=mode, optimizer=optimizer)
    entries = {
        "validate_config": lambda: tslam.validate_config(scfg),
        "solve_batch": lambda: tmesh.solve_batch(*_targs(world), TMAP, cfg, mode, optimizer),
        "make_sharded_solver": lambda: tmesh.make_sharded_solver(
            tmesh.make_mesh(device="cpu"), TMAP, cfg, mode),
        "check_fleet_cfg": lambda: tfleet._check_fleet_cfg(scfg),
    }
    with pytest.raises(ValueError) as want:
        tsolve.check(mode, optimizer, node=site in ("validate_config", "check_fleet_cfg"))
    with pytest.raises(ValueError, match=match) as got:
        entries[site]()
    assert str(got.value) == str(want.value)


# ------------------------------------------------ one solve per cluster

H100_SMEM = 232448  # an H100's shared memory per block (opt-in)
# Clusters of C CTAs an H100 holds at once (chip_smoke.py phase 5c, K2 at
# P=4096, N=384): one CTA per SM, 15 clusters of 8 at most.
H100_HELD = {1: 132, 2: 66, 4: 30, 8: 15}.get


# K2's C at P=4096 for B solves (rows) of N points (columns): the fewest
# waves, then the largest C: one wave of C=8 at B <= 15, of C=4 at B=16; at
# B=256 one CTA holds the particle state and w unless N=1024's w needs two.
@pytest.mark.parametrize("batch,n_pts,want", [
    (b, n, c) for b, row in ((1, (8, 8, 8)), (3, (8, 8, 8)), (16, (4, 4, 4)), (256, (1, 1, 2)))
    for n, c in zip((100, 384, 1024), row)
])
def test_rollout_cluster_chooser_table(batch, n_pts, want):
    need = lambda c: tro.smem_bytes(n_pts, 4096, c)
    assert _build.choose_cluster(batch, need, H100_SMEM, H100_HELD) == want


@pytest.mark.parametrize("n_pts,most", [(384, 5189), (1024, 5073), (100, 5240)])
def test_rollout_max_population(n_pts, most):
    """K2's route threshold: on the shared route every CTA holds the whole
    particle state in shared memory, so the most particles is what fits
    beside w's slice at C=8.  One more particle takes the global route,
    whose CTA holds only w, so the chooser picks C by the waves alone, and
    no population is refused."""
    assert tro.max_population(n_pts, H100_SMEM) == most
    assert not tro.global_route(n_pts, most, H100_SMEM)
    need = lambda p, glob: (lambda c: tro.smem_bytes(n_pts, p, c, glob))
    assert _build.choose_cluster(16, need(most, False), H100_SMEM, H100_HELD) == 8
    with pytest.raises(ValueError, match="no cluster size"):
        _build.choose_cluster(16, need(most + 1, False), H100_SMEM, H100_HELD)
    for p in (most + 1, 8192, 16384, 10**6):
        assert tro.global_route(n_pts, p, H100_SMEM)
        assert tro.smem_bytes(n_pts, p, 1, True) == 4 * 16 * n_pts
        assert _build.choose_cluster(3, need(p, True), H100_SMEM, H100_HELD) == 8
        assert _build.choose_cluster(16, need(p, True), H100_SMEM, H100_HELD) == 4
        assert _build.choose_cluster(256, need(p, True), H100_SMEM, H100_HELD) == 1


def _frozen_inputs(world, n=None, seed=4):
    sten, pts = _port_packed(world)
    if n is not None:
        sten, pts = sten[..., :n], pts[..., :n]
    rs = np.random.RandomState(seed)
    guesses = torch.from_numpy(world["guesses"])
    poses = guesses[:, None, :] + torch.from_numpy(
        (rs.uniform(-0.3, 0.3, (B, 64, 3)) * [1.0, 1.0, 0.2]).astype(np.float32))
    return poses, guesses, sten, pts


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_rank_sliced_frozen_cost_matches_plain(world, cluster):
    """K2's sum order on C CTAs (per-rank partials, then rank order) against
    the plain one-pass sum, at the frozen-solve cost tolerance."""
    poses, binds, sten, pts = _frozen_inputs(world)
    sliced = tro.packed_frozen_cost(poses, binds, sten, pts, TMAP, cluster=cluster)
    plain = tro.packed_frozen_cost(poses, binds, sten, pts, TMAP)
    assert (sliced < -1.0).sum() > 32
    np.testing.assert_allclose(sliced.numpy(), plain.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("cluster", [2, 8])
def test_plain_rollout_in_cluster_order(world, cluster):
    """On the CPU, cluster=C runs K2's plain version with the kernel's sum
    order on C CTAs (the order the gpu tests hold the kernel to), within the
    frozen-solve tolerance of the one-pass order."""
    cfg = tcfg.PSOConfig(iterations=6, population=64)
    sten, pts = _port_packed(world)
    args = (*_targs(world)[:3], sten, pts, cfg, TMAP)
    p1, c1 = tro.pso_rollout(*args)
    pc, cc = tro.pso_rollout(*args, cluster=cluster)
    ref = tro.pso_rollout_reference(*args, cluster=cluster)
    assert torch.equal(cc, ref[1]) and torch.equal(pc, ref[0])
    np.testing.assert_allclose(cc.numpy(), c1.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(pc.numpy(), p1.numpy(), atol=5e-3)


def test_padded_points_score_zero_in_the_frozen_cost(world):
    """Points past N (a ragged N=203 padded to a multiple of C=8 with zero
    columns: invalid, unbuilt) score exactly 0 and leave the solve as it
    was."""
    poses, binds, sten, pts = _frozen_inputs(world, 203)
    pad = 5
    psten = torch.cat([sten, torch.zeros((*sten.shape[:-1], pad))], dim=-1)
    ppts = torch.cat([pts, torch.zeros((*pts.shape[:-1], pad))], dim=-1)
    only = tro.packed_frozen_cost(poses, binds, psten[..., 203:], ppts[..., 203:], TMAP)
    assert torch.equal(only, torch.zeros_like(only))
    cfg = tcfg.PSOConfig(iterations=6, population=64)
    keys, guesses, devs = _targs(world)[:3]
    p0, c0 = tro.pso_rollout(keys, guesses, devs, sten, pts, cfg, TMAP)
    p1, c1 = tro.pso_rollout(keys, guesses, devs, psten, ppts, cfg, TMAP)
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), atol=5e-3)


# ------------------------------------------------ the kernels, on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


# Seconds a kernel may take before its test fails: a cluster whose CTAs
# disagree on a barrier deadlocks, and must fail rather than hang.
GPU_TIMEOUT_S = 120


def synced(seconds=GPU_TIMEOUT_S):
    """Waits for the card's queued work, failing after `seconds`."""
    stream = torch.cuda.current_stream()
    deadline = time.monotonic() + seconds
    while not stream.query():
        if time.monotonic() > deadline:
            pytest.fail(f"the kernel did not finish within {seconds} s (a cluster deadlock?)")
        time.sleep(1e-3)


def _check_rollout(args, cluster=None, **variant):
    before = tro.pso_rollout.LAUNCHES
    kp, kc = tro.pso_rollout(*args, cluster=cluster, **variant)
    synced()
    assert tro.pso_rollout.LAUNCHES == before + 1
    # The plain version sums the points in the order of the kernel's cluster.
    rp, rc = tro.pso_rollout_reference(*args, **variant, cluster=tro.pso_rollout.LAST_CLUSTER)
    rtol, atol, patol = _TOL["rollout_bf16" if variant.get("score_dtype") else "rollout"]
    np.testing.assert_allclose(kc.cpu().numpy(), rc.cpu().numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(kp.cpu().numpy(), rp.cpu().numpy(), atol=patol)
    return tro.pso_rollout.LAST_CLUSTER


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("population", [50, 200, 700])
@pytest.mark.parametrize("variant", [
    dict(), dict(score_dtype="bf16"), dict(rng_mode="native"), dict(early_exit=2),
    dict(exp_mode="approx"),
])
def test_rollout_kernel_matches_plain_on_gpu(world, cuda_device, population, variant, cluster):
    """K2 against its plain version on the same card tensors, on clusters of
    every size (None: the chooser's, 8 at B=3).  The kernel sums z = w·φ
    feature by feature, the plain version by matrix product, so they are
    held to the frozen-solve tolerance (bf16: its own); the draws are the
    same bits."""
    cfg = tcfg.PSOConfig(iterations=10, population=population)
    sten, pts = _port_packed(world, cuda_device)
    args = (*_targs(world, device=cuda_device)[:3], sten, pts, cfg, TMAP)
    assert _check_rollout(args, cluster, **variant) == (cluster or 8)


def _batch_args(world, dev, n, batch, cfg, local=False):
    """Kernel arguments for `batch` solves (the world's 3, cycled) of its
    first n points, on dev."""
    keys, guesses, devs, snaps, points, valid = _targs(world, device=dev)
    nbr = tcost.bind_neighborhood(guesses, snaps, points, valid, TMAP)
    if local:
        sten, pts = trl.pack_rollout_local_inputs(nbr, points)
        sten, pts = sten[:, :, :n], pts[:, :n]
    else:
        sten, pts = tro.pack_rollout_inputs(nbr, points)
        sten, pts = sten[..., :n], pts[..., :n]
    idx = torch.arange(batch, device=dev) % B
    return (keys[idx], guesses[idx], devs[idx], sten[idx].contiguous(), pts[idx].contiguous(),
            cfg, TMAP)


@pytest.mark.gpu
@pytest.mark.parametrize("early_exit", [0, 2])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_rollout_kernel_ragged_points_and_batches_on_gpu(world, cuda_device, batch, early_exit):
    """N=100 (not a multiple of C: the last CTA's slice is short), B in
    {1, 3, 16}, with and without the early exit, which every CTA of a
    cluster must take at the same iteration; f32 and the turbo bf16 mode."""
    cfg = tcfg.PSOConfig(iterations=12, population=256)
    args = _batch_args(world, cuda_device, 100, batch, cfg)
    for cluster in (None, 4):
        _check_rollout(args, cluster, early_exit=early_exit)
    _check_rollout(args, None, early_exit=early_exit, rng_mode="native", score_dtype="bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
def test_rollout_local_turbo_kernel_matches_plain_on_gpu(world, cuda_device, cluster):
    cfg = tcfg.PSOConfig(iterations=10, population=50)
    args = _batch_args(world, cuda_device, N_PAD, B, cfg, local=True)
    kp, kc = trl.pso_rollout_local(*args, rng_mode="native", cluster=cluster)
    synced()
    assert trl.pso_rollout_local.LAST_CLUSTER == (cluster or 8)
    rp, rc = trl.pso_rollout_local_reference(*args, rng_mode="native", cluster=cluster or 8)
    np.testing.assert_allclose(kc.cpu().numpy(), rc.cpu().numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(kp.cpu().numpy(), rp.cpu().numpy(), atol=1e-5)


@pytest.mark.gpu
def test_rollout_smem_matches_its_plain_formula_on_gpu(cuda_device):
    lib = _build.load(tro.LIB)
    for n, p, c in ((100, 50, 8), (384, 4096, 1), (1024, 4096, 2), (5, 1, 4), (384, 16384, 8)):
        for glob in (False, True):
            assert lib.ndt_rollout_smem_bytes(n, p, c, glob) == tro.smem_bytes(n, p, c, glob)
        assert lib.ndt_rollout_slice_floats(p) == _build.slice_floats(p)


def _args_384(world, dev, cfg, local=False):
    """Kernel arguments for the world's B solves with their 200 points padded
    to N=384 (the padding invalid), on dev."""
    keys, guesses, devs, snaps, points, valid = _targs(world, device=dev)
    points = torch.cat([points, points.new_zeros((B, 384 - N_PAD, 2))], dim=1)
    valid = torch.cat([valid, valid.new_zeros((B, 384 - N_PAD))], dim=1)
    nbr = tcost.bind_neighborhood(guesses, snaps, points, valid, TMAP)
    pack = trl.pack_rollout_local_inputs if local else tro.pack_rollout_inputs
    return (keys, guesses, devs, *pack(nbr, points), cfg, TMAP)


@pytest.mark.gpu
@pytest.mark.parametrize("population", [8192, 16384])
@pytest.mark.parametrize("variant", [dict(), dict(score_dtype="bf16", rng_mode="native")])
def test_rollout_large_population_on_gpu(world, cuda_device, population, variant):
    """K2 above its shared-memory route (5,189 particles at N=384): the
    state in global scratch, held to the plain version in the cluster's
    order, N=384, B=3, I=10, on the chooser's C and on one CTA."""
    cfg = tcfg.PSOConfig(iterations=10, population=population)
    args = _args_384(world, cuda_device, cfg)
    for cluster in (None, 1):
        assert _check_rollout(args, cluster, **variant) == (cluster or 8)
        assert tro.pso_rollout.LAST_ROUTE == "global"
    shared = dataclasses.replace(cfg, population=tro.max_population(384, H100_SMEM))
    _check_rollout(_args_384(world, cuda_device, shared))
    assert tro.pso_rollout.LAST_ROUTE == "shared"


@pytest.mark.gpu
def test_rollout_local_large_population_on_gpu(world, cuda_device):
    """K1 above its register route (16 particles per thread, 8,192): the
    state in global scratch, P=16,384, N=384, B=3, I=10, held to the plain
    version in the cluster's order, Threefry and turbo."""
    cfg = tcfg.PSOConfig(iterations=10, population=16384)
    args = _args_384(world, cuda_device, cfg, local=True)
    for kw in (dict(), dict(rng_mode="native")):
        kp, kc = trl.pso_rollout_local(*args, **kw)
        synced()
        assert trl.pso_rollout_local.LAST_ROUTE == "global"
        rp, rc = trl.pso_rollout_local_reference(*args, **kw,
                                                 cluster=trl.pso_rollout_local.LAST_CLUSTER)
        np.testing.assert_allclose(kc.cpu().numpy(), rc.cpu().numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(kp.cpu().numpy(), rp.cpu().numpy(), atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("features", [15, 16])
@pytest.mark.parametrize("population", [1, 300, 2048])
def test_score_kernel_matches_plain_on_gpu(cuda_device, features, population):
    g = torch.Generator().manual_seed(features + population)
    phit = torch.randn(4, features, population, generator=g) * 0.3
    w = torch.randn(4, 384, features, generator=g)
    mask = (torch.rand(4, 384, generator=g) > 0.2).float()
    args = [t.to(cuda_device) for t in (phit, w, mask)]
    before = tscore.fused_bound_scores.LAUNCHES
    got = tscore.fused_bound_scores(*args)
    torch.cuda.synchronize()
    assert tscore.fused_bound_scores.LAUNCHES == before + 1
    ref = tscore.fused_bound_scores_reference(*args)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-4)
