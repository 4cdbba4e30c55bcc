"""The port's frozen-correspondence pieces against the JAX package, on the
CPU: the Philox stream of the turbo modes, the binders and the quadratic-form
cost (models/cost.py), the fused scoring module (ops/score.py), and the
batched solver (models/pso.py:pso_solve_batch).

Tolerances, with their reasons:

* Philox words and draws: bit for bit against the Random123 known-answer
  vectors and against Python's exact integer arithmetic;
* binders and pose features against the JAX package: rtol 1e-6 — the same
  operation order, but PyTorch's and XLA's CPU sin/cos differ in the last
  ulp;
* bound_cost: rtol 1e-5 / atol 1e-4, the JAX package's own tolerance
  between two summation orders of the same cost (tests/test_parallel.py's
  fused-vs-XLA check): z = φ·w sums 15 terms that cancel down to a small
  quadratic form, and the two matrix products sum them in different orders
  (measured: up to 8e-6 relative, 4e-5 absolute on costs near -5);
* the plain scoring version against the JAX kernel (interpret mode):
  rtol 1e-5 / atol 1e-4, the JAX package's own fused-vs-XLA tolerance;
* pso_solve_batch against a loop of pso_solve: bit for bit (the same draws
  and update rule, tests/test_parallel.py:199-221).
"""

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import pso as tpso
from ndtpso_slam_tpu_torch.ops import rng as trng
from ndtpso_slam_tpu_torch.ops import score as tscore
from ndtpso_slam_tpu_torch.utils.state import snapshot_from_numpy

import jax
import jax.numpy as jnp

from ndtpso_slam_tpu import config as jcfg
from ndtpso_slam_tpu.models import cost as jcost
from ndtpso_slam_tpu.models import ndt_map as jmap
from ndtpso_slam_tpu.ops import pallas_score as jscore

TMAP = tcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
JMAP = jcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ Philox

# Random123's known-answer vectors for philox4x32_10 (kat_vectors).
PHILOX_KAT = [
    ((0, 0), (0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32), (M32, M32, M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("key,ctr,expect", PHILOX_KAT)
def test_philox_known_answers(key, ctr, expect):
    assert trng._philox(*key, *ctr) == expect  # Python ints
    got = trng.philox4x32(key, torch.tensor([ctr[0]] * 2), *ctr[1:])  # int64 lanes
    assert tuple(int(w[1]) for w in got) == expect


def test_philox_mulhilo_is_exact_in_int64_lanes():
    """The 32x32 -> 64 product overflows an int64 lane; the split into
    16-bit halves gives the exact high and low words."""
    rs = np.random.RandomState(0)
    m = rs.randint(0, 2**32, 4096, dtype=np.uint64)
    x = np.concatenate([[0, 1, M32, M32 - 1], rs.randint(0, 2**32, 4092, dtype=np.uint64)])
    hi, lo = trng._mulhilo(torch.from_numpy(m.astype(np.int64)), torch.from_numpy(x.astype(np.int64)))
    exact = [int(a) * int(b) for a, b in zip(m, x)]
    np.testing.assert_array_equal(hi.numpy(), [p >> 32 for p in exact])
    np.testing.assert_array_equal(lo.numpy(), [p & M32 for p in exact])


def test_philox_pso_layout():
    """pso_draws' turbo stream follows the documented counter layout, and
    the batched draws give each solve the same values."""
    key, p, iters = (0x12345678, 0x9ABCDEF0), 7, 3
    u_g, u_p, r1, r2 = tpso.pso_draws(key, p, iters, torch.float32, "cpu", "native")
    u = lambda *c: [(w >> 8) * 2.0**-24 for w in trng._philox(*key, *c)[:3]]
    np.testing.assert_array_equal(u_g.numpy(), np.float32(u(0, 0, trng.PHILOX_SEED, 0)))
    for j in range(p):
        np.testing.assert_array_equal(u_p[j].numpy(), np.float32(u(j, 0, trng.PHILOX_INIT, 0)))
        for i in range(iters):
            np.testing.assert_array_equal(r1[i, j].numpy(), np.float32(u(j, i + 1, trng.PHILOX_R1, 0)))
            np.testing.assert_array_equal(r2[i, j].numpy(), np.float32(u(j, i + 1, trng.PHILOX_R2, 0)))
    keys = torch.tensor([key, (1, 2)])
    bg, bp = tpso._batch_draws(keys, None, p, torch.float32, "cpu", "native")
    np.testing.assert_array_equal(bg[0].numpy(), u_g.numpy())
    np.testing.assert_array_equal(bp[0].numpy(), u_p.numpy())
    b1, b2 = tpso._batch_draws(keys, 2, p, torch.float32, "cpu", "native")
    np.testing.assert_array_equal(b1[0].numpy(), r1[2].numpy())
    np.testing.assert_array_equal(b2[0].numpy(), r2[2].numpy())
    assert not np.array_equal(b1[1].numpy(), r1[2].numpy())


def test_philox_uniforms_are_uniform():
    u = trng.philox_uniforms((3, 9), torch.arange(200_000), 1, trng.PHILOX_R1).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(0), 0.5, atol=3e-3)
    np.testing.assert_allclose(u.var(0), 1.0 / 12.0, atol=1e-3)
    assert np.abs(np.corrcoef(u.T)[np.triu_indices(3, 1)]).max() < 0.01


# ---------------------------------------------------------------- binders


@pytest.fixture(scope="module")
def world():
    """The ellipse map of the JAX package's tests (built by the port, which
    matches the JAX map bit for bit on the CPU), 3 binding poses and 3 point
    sets (200 points padded to 256), as numpy arrays."""
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))).astype(np.float32)
    state = tmap.init_map(TMAP, device="cpu")
    for _ in range(2):
        noisy = pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)
        tmap.add_points(state, TMAP, torch.from_numpy(noisy), torch.ones(200, dtype=torch.bool))
        tmap.build(state, TMAP)
    ts = tmap.snapshot(state, TMAP)
    rs = np.random.RandomState(2)
    points = np.zeros((3, 256, 2), np.float32)
    points[:, :200] = pts[None] + rs.normal(0, 0.1, (3, 200, 2)).astype(np.float32)
    valid = np.zeros((3, 256), bool)
    valid[:, :200] = True
    valid[1, 10:30] = False
    return dict(
        snap=dict(mean=ts.mean.numpy(), inv_cov=ts.inv_cov.numpy(), built=ts.built.numpy()),
        binds=np.float32([[0.0, 0.0, 0.0], [0.3, -0.2, 0.05], [-0.6, 0.4, -0.1]]),
        anchors=np.float32([[0.0, 0.0, 0.0], [0.2, -0.1, 0.03], [-0.3, 0.3, -0.05]]),
        poses=np.stack([b + rs.uniform(-0.4, 0.4, (64, 3)).astype(np.float32) * np.float32([1, 1, 0.2])
                        for b in np.float32([[0.0, 0.0, 0.0], [0.3, -0.2, 0.05], [-0.6, 0.4, -0.1]])]),
        points=points, valid=valid,
    )


def _jsnap(world):
    return jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in world["snap"].items()})


# The JAX binders run op by op: each op rounds as the port's does, where
# XLA's fusion of the whole binder moves w by up to 4e-5 relative.
_JBINDERS = {
    "bind_points": lambda b, s, p, v, a: jcost.bind_points(b, s, p, v, JMAP),
    "bind_points_matmul": lambda b, s, p, v, a: jcost.bind_points_matmul(
        b, jcost.snapshot_table(s), p, v, JMAP),
    "bind_points_local": lambda b, s, p, v, a: jcost.bind_points_local(
        b, jcost.bind_neighborhood(a, s, p, v, JMAP), p, JMAP),
}
# Features and costs compiled as the JAX package's solver runs them (one
# XLA compile each, where op-by-op dispatch compiles every op).
_jfeatures = jax.jit(lambda poses, bind: (jcost.pose_features(poses, bind),
                                          jcost.pose_features_t(poses, bind)))
_jbound_cost = jax.jit(jcost.bound_cost)


def _bind_both(world, binder, b):
    """The port's and the JAX package's BoundScan of solve b."""
    tsnap = snapshot_from_numpy(world["snap"], "cpu")
    bind, pts, val, anchor = (world[k][b] for k in ("binds", "points", "valid", "anchors"))
    tb, tp, tv = (torch.from_numpy(a) for a in (bind, pts, val))
    jbound = _JBINDERS[binder](jnp.asarray(bind), _jsnap(world), jnp.asarray(pts),
                               jnp.asarray(val), jnp.asarray(anchor))
    if binder == "bind_points":
        return tcost.bind_points(tb, tsnap, tp, tv, TMAP), jbound
    if binder == "bind_points_matmul":
        return tcost.bind_points_matmul(tb, tcost.snapshot_table(tsnap), tp, tv, TMAP), jbound
    tn = tcost.bind_neighborhood(torch.from_numpy(anchor), tsnap, tp, tv, TMAP)
    return tcost.bind_points_local(tb, tn, tp, TMAP), jbound


BINDERS = ["bind_points", "bind_points_matmul", "bind_points_local"]


@pytest.mark.parametrize("binder", BINDERS)
def test_binders_match_jax(world, binder):
    for b in range(3):
        t, j = _bind_both(world, binder, b)
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        assert 0 < t.mask.sum() < 256
        np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), rtol=1e-6, atol=1e-6)
        assert (t.w.numpy()[t.mask.numpy() == 0] == 0).all()


@pytest.mark.parametrize("binder", BINDERS)
def test_batched_binders_equal_per_solve(world, binder):
    """One batched call over B solves (a snapshot per solve) gives each
    solve's bits."""
    tsnap = snapshot_from_numpy(world["snap"], "cpu")
    snaps = snapshot_from_numpy({k: np.stack([v] * 3) for k, v in world["snap"].items()}, "cpu")
    tb, tp, tv = (torch.from_numpy(world[k]) for k in ("binds", "points", "valid"))
    if binder == "bind_points":
        batched = tcost.bind_points(tb, snaps, tp, tv, TMAP)
        single = [tcost.bind_points(tb[b], tsnap, tp[b], tv[b], TMAP) for b in range(3)]
    elif binder == "bind_points_matmul":
        tbl = tcost.snapshot_table(tsnap)
        batched = tcost.bind_points_matmul(tb, torch.stack([tbl] * 3), tp, tv, TMAP)
        single = [tcost.bind_points_matmul(tb[b], tbl, tp[b], tv[b], TMAP) for b in range(3)]
    else:
        anchors = torch.from_numpy(world["anchors"])
        nbrs = tcost.bind_neighborhood(anchors, snaps, tp, tv, TMAP)
        batched = tcost.bind_points_local(tb, nbrs, tp, TMAP)
        single = [
            tcost.bind_points_local(
                tb[b], tcost.bind_neighborhood(anchors[b], tsnap, tp[b], tv[b], TMAP), tp[b], TMAP)
            for b in range(3)
        ]
    for b in range(3):
        np.testing.assert_array_equal(batched.w[b].numpy(), single[b].w.numpy())
        np.testing.assert_array_equal(batched.mask[b].numpy(), single[b].mask.numpy())


def test_bound_cost_and_features_match_jax(world):
    for b in range(3):
        t, j = _bind_both(world, "bind_points", b)
        poses, bind = world["poses"][b], world["binds"][b]
        jphi, jphit = _jfeatures(jnp.asarray(poses), jnp.asarray(bind))
        np.testing.assert_allclose(
            tcost.pose_features(torch.from_numpy(poses), torch.from_numpy(bind)).numpy(),
            np.asarray(jphi), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            tcost.pose_features_t(torch.from_numpy(poses), torch.from_numpy(bind)).numpy(),
            np.asarray(jphit), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            tcost.bound_cost(torch.from_numpy(poses), t).numpy(),
            np.asarray(_jbound_cost(jnp.asarray(poses), j)), rtol=1e-5, atol=1e-4)


def test_bound_cost_scores_zero_where_masked_and_clamps(world):
    """Masked points add nothing; a negative quadratic form is clamped, so
    every score stays in (0, 1]."""
    t, _ = _bind_both(world, "bind_points", 1)
    poses = torch.from_numpy(world["poses"][1])
    full = tcost.bound_cost(poses, t)
    t.w[:, 14] = -5.0  # a negative form on every point
    clamped = tcost.bound_cost(poses, t)
    assert (clamped >= -t.mask.sum() - 1e-3).all() and (full > clamped).all()


# ------------------------------------------------------------ fused scoring


@pytest.mark.parametrize("features,population", [(15, 100), (16, 256), (15, 1)])
def test_plain_scores_match_jax_kernel(features, population):
    """The plain version of the scoring kernel against the JAX Pallas kernel
    in interpret mode, on the same inputs; 15 or 16 features, any P."""
    rs = np.random.RandomState(features + population)
    phit = (rs.normal(0, 0.3, (2, features, population))).astype(np.float32)
    w = rs.normal(0, 1.0, (2, 256, features)).astype(np.float32)
    mask = (rs.uniform(size=(2, 256)) > 0.2).astype(np.float32)
    ref = jscore.fused_bound_scores(jnp.asarray(phit), jnp.asarray(w), jnp.asarray(mask),
                                    interpret=True)
    before = tscore.fused_bound_scores.LAUNCHES
    got = tscore.fused_bound_scores(*(torch.from_numpy(a) for a in (phit, w, mask)))
    assert tscore.fused_bound_scores.LAUNCHES == before  # CPU tensors never launch
    assert got.shape == (2, population)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_bound_cost_fused_matches_jax(world):
    """bound_cost_fused on the batched bind of three solves (the plain
    bound_cost here) against the JAX fused path in interpret mode."""
    snaps = {k: np.stack([v] * 3) for k, v in world["snap"].items()}
    tb = tcost.bind_points(*(torch.from_numpy(world[k]) for k in ("binds",)),
                           snapshot_from_numpy(snaps, "cpu"),
                           torch.from_numpy(world["points"]), torch.from_numpy(world["valid"]), TMAP)
    @jax.jit
    def jax_fused(poses, binds, mean, inv_cov, built, points, valid):
        jb = jax.vmap(lambda b, m, i, u, p, v: jcost.bind_points(
            b, jmap.MapSnapshot(mean=m, inv_cov=i, built=u), p, v, JMAP))(
            binds, mean, inv_cov, built, points, valid)
        return jcost.bound_cost_fused(poses, jb, interpret=True)

    got = tcost.bound_cost_fused(torch.from_numpy(world["poses"]), tb)
    ref = jax_fused(*(jnp.asarray(a) for a in (
        world["poses"], world["binds"], snaps["mean"], snaps["inv_cov"], snaps["built"],
        world["points"], world["valid"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ batched PSO


@pytest.mark.parametrize("rng_mode,early_exit", [("threefry", 0), ("native", 0), ("threefry", 2)])
def test_pso_solve_batch_equals_loop_of_pso_solve(world, rng_mode, early_exit):
    """The batched solver reproduces a loop of pso_solve bit for bit: the
    same per-solve streams, update rule and (per-solve) early exit."""
    tsnap = snapshot_from_numpy(world["snap"], "cpu")
    pts, val = torch.from_numpy(world["points"]), torch.from_numpy(world["valid"])
    cfg = tcfg.PSOConfig(iterations=6, population=40)
    rs = np.random.RandomState(5)
    keys = torch.from_numpy(rs.randint(0, 2**31, (3, 2)).astype(np.int64))
    guesses = torch.from_numpy(world["anchors"])
    devs = torch.tensor([[0.3, 0.3, 0.05]] * 3)
    cost_b = lambda b: (lambda poses, bind: tcost.bound_cost(
        poses, tcost.bind_points(bind, tsnap, pts[b], val[b], TMAP)))
    batched = tpso.pso_solve_batch(
        keys, guesses, devs,
        lambda poses, binds: torch.stack([cost_b(b)(poses[b], binds[b]) for b in range(3)]),
        cfg, rng_mode=rng_mode, early_exit=early_exit)
    for b in range(3):
        one = tpso.pso_solve((int(keys[b, 0]), int(keys[b, 1])), guesses[b], devs[b], cost_b(b),
                             cfg, early_exit=early_exit, rng_mode=rng_mode)
        np.testing.assert_array_equal(batched.pose[b].numpy(), one.pose.numpy())
        np.testing.assert_array_equal(batched.cost[b].numpy(), one.cost.numpy())


def test_pso_rejects_unknown_rng_mode():
    with pytest.raises(ValueError, match="rng_mode"):
        tpso.pso_draws((1, 2), 4, 2, torch.float32, "cpu", "hardware")
