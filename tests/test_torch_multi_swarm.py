"""The port's multi-swarm PSO (parallel/multi_swarm.py) and the cluster
chooser of the whole-solve kernels (ops/_build.py) against the JAX package,
on the CPU.

Tolerances, with their reasons:

* ``multi_swarm_solve`` with the exact cost: poses 1e-5, costs rtol 1e-5 —
  the same Threefry draws, update rule and first-minimum merges; the costs
  differ by the ulps of PyTorch's and XLA's exp (tests/test_torch_batch.py's
  per-particle tolerance);
* ``multi_swarm_rollout``: K2's plain version against the JAX kernel in
  interpret mode, at K2's frozen-solve tolerances (costs rtol 1e-4 / atol
  1e-3, poses 5e-3; tests/test_rollout.py); the merged cost is the exact cost
  of the merged pose (rtol 1e-5, as the JAX package holds its own).

The ``gpu`` tests run the kernels on the card (K2 at K=16, P=4096 held to
its plain version in the order of its cluster; the chooser's picks) and skip
here.  The GPU machine has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_multi_swarm.py``.
"""

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import pso as tpso
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops import rollout as tro
from ndtpso_slam_tpu_torch.ops import rollout_local as trl
from ndtpso_slam_tpu_torch.parallel import mesh as tmesh
from ndtpso_slam_tpu_torch.parallel import multi_swarm as tms
from ndtpso_slam_tpu_torch.utils.state import snapshot_from_numpy

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import cost as jcost
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.parallel import multi_swarm as jms

    JMAP = jcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")

TMAP = tcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
K, P, I = 4, 64, 12  # tests/test_parallel.py's multi-swarm shape
DEV = np.float32([0.2, 0.2, 0.05])


@pytest.fixture(scope="module")
def world():
    """tests/test_parallel.py's world (an ellipse of 200 points mapped twice
    on a 32 m map of 1 m cells), built by the port, which matches the JAX
    map bit for bit on the CPU; the keys and guesses of its multi-swarm
    test."""
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))).astype(np.float32)
    state = tmap.init_map(TMAP, device="cpu")
    for _ in range(2):
        noisy = pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)
        tmap.add_points(state, TMAP, torch.from_numpy(noisy), torch.ones(200, dtype=torch.bool))
        tmap.build(state, TMAP)
    snap = tmap.snapshot(state, TMAP)
    rs = np.random.RandomState(2)
    return dict(snap={k: getattr(snap, k).numpy() for k in ("mean", "inv_cov", "built")}, pts=pts,
                keys=rs.randint(0, 2**31, (K, 2)).astype(np.uint32),
                guesses=rs.uniform(-0.2, 0.2, (K, 3)).astype(np.float32))


def _port_exact_cost(world, device="cpu"):
    snap = snapshot_from_numpy(world["snap"], device)
    pts = torch.from_numpy(world["pts"]).to(device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    return lambda poses, binds: tcost.ndt_cost(poses, snap, pts, valid, TMAP)


def _port_solve(world, exchange_every, cfg=None):
    return tms.multi_swarm_solve(
        torch.from_numpy(world["keys"].astype(np.int64)), torch.from_numpy(world["guesses"]),
        DEV, _port_exact_cost(world), cfg or tcfg.PSOConfig(iterations=I, population=P),
        exchange_every=exchange_every)


@needs_jax
@pytest.mark.parametrize("exchange_every", [1, 3, 12])
def test_multi_swarm_solve_matches_jax(world, exchange_every):
    """Every swarm exchanging each iteration, every third, and only at the
    final merge, against the JAX solver with the exact cost."""
    snap = jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in world["snap"].items()})
    pts, valid = jnp.asarray(world["pts"]), jnp.ones(world["pts"].shape[0], bool)
    cost_fn = lambda poses, bind: jcost.ndt_cost(poses, snap, pts, valid, JMAP)
    ref = jax.jit(lambda k, g: jms.multi_swarm_solve(
        k, g, DEV, cost_fn, jcfg.PSOConfig(iterations=I, population=P),
        exchange_every=exchange_every))(world["keys"], world["guesses"])
    got = _port_solve(world, exchange_every)
    assert got.pose.shape == (3,) and got.cost.shape == ()
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-5)


def test_multi_swarm_beats_or_matches_single(world):
    """Mirror of tests/test_parallel.py::test_multi_swarm_beats_or_matches_single:
    the map was built at identity, so the best pose is near zero."""
    res = _port_solve(world, 3)
    assert np.abs(res.pose.numpy()[:2]).max() < 0.1
    assert float(res.cost) < -50.0


def test_exchange_makes_every_swarm_adopt_the_merged_best(world):
    """The island merge: after an exchange every swarm holds the first
    minimum of all incumbents; without one the swarms keep their own."""
    args = (torch.from_numpy(world["keys"].astype(np.int64)), torch.from_numpy(world["guesses"]),
            torch.from_numpy(np.tile(DEV, (K, 1))), _port_exact_cost(world),
            tcfg.PSOConfig(iterations=4, population=P))
    every_2, _ = tms.island_exchange(2)
    merged = tpso.pso_solve_batch(*args, exchange=every_2)
    assert (merged.pose == merged.pose[0]).all() and (merged.cost == merged.cost[0]).all()
    apart = tpso.pso_solve_batch(*args)
    assert len(set(apart.cost.tolist())) > 1
    assert float(merged.cost[0]) <= float(apart.cost.min())
    with pytest.raises(ValueError, match="cannot be combined"):
        tpso.pso_solve_batch(*args, early_exit=2, exchange=every_2)


def test_multi_swarm_keeps_dtype_and_rejects_the_mesh(world):
    cfg = tcfg.PSOConfig(iterations=2, population=8)
    res = tms.multi_swarm_solve(
        torch.from_numpy(world["keys"].astype(np.int64)),
        torch.from_numpy(world["guesses"]).double(), DEV,
        lambda poses, binds: _port_exact_cost(world)(poses.float(), binds).double(), cfg)
    assert res.pose.dtype == torch.float64 and res.cost.dtype == torch.float64
    # A merge across ranks needs the rank's mesh; at world 1 it is the
    # merge over the swarm axis.
    args = (torch.zeros((1, 2), dtype=torch.int64), torch.zeros((1, 3)), DEV,
            lambda p, b: p[..., 0], cfg)
    for kw in (dict(axis_name="solves"), dict(dcn_axis_name="hosts")):
        with pytest.raises(ValueError, match="needs the rank's mesh"):
            tms.multi_swarm_solve(*args, **kw)
    mesh = tmesh.make_mesh(device="cpu")
    alone = tms.multi_swarm_solve(*args)
    for kw in (dict(axis_name="solves"), dict(dcn_axis_name="solves", dcn_exchange_every=2)):
        got = tms.multi_swarm_solve(*args, mesh=mesh, **kw)
        assert torch.equal(got.pose, alone.pose) and torch.equal(got.cost, alone.cost)


# -------------------------------------------------------- multi_swarm_rollout

N_PAD = 256
TRUE = np.float32([0.3, -0.2, 0.05])


def _rollout_inputs(world):
    """tests/test_rollout.py::test_multi_swarm_rollout_relocalizes's inputs:
    the map's points seen from TRUE, padded to 256, K=4 hypotheses, one near
    the solution (its inverse)."""
    c, s = np.cos(TRUE[2]), np.sin(TRUE[2])
    pts = world["pts"]
    moved = np.stack([pts[:, 0] * c - pts[:, 1] * s + TRUE[0],
                      pts[:, 0] * s + pts[:, 1] * c + TRUE[1]], -1).astype(np.float32)
    inv = np.float32([-(TRUE[0] * c + TRUE[1] * s), TRUE[0] * s - TRUE[1] * c, -TRUE[2]])
    points = np.zeros((N_PAD, 2), np.float32)
    points[:200] = moved
    valid = np.zeros(N_PAD, bool)
    valid[:200] = True
    rs = np.random.RandomState(7)
    keys = rs.randint(0, 2**31, (K, 2)).astype(np.uint32)
    hypo = inv + rs.uniform(-1.0, 1.0, (K, 3)).astype(np.float32) * np.float32([1, 1, 0.1])
    hypo[1] = inv + np.float32([0.15, -0.1, 0.02])
    return inv, keys, hypo, points, valid


ROLLOUT_CFG = dict(iterations=15, population=128)
ROLLOUT_DEV = np.float32([0.4, 0.4, 0.08])


@needs_jax
def test_multi_swarm_rollout_matches_jax(world):
    """Mirror of tests/test_rollout.py::test_multi_swarm_rollout_relocalizes
    (K=4, P=128, I=15): the port's K2 plain version against the JAX kernel in
    interpret mode; the merged pose passes the JAX test's gate and its cost
    is the exact cost of that pose."""
    inv, keys, hypo, points, valid = _rollout_inputs(world)
    snap = jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in world["snap"].items()})
    ref = jax.jit(lambda k, h: jms.multi_swarm_rollout(
        k, h, ROLLOUT_DEV, snap, jnp.asarray(points), jnp.asarray(valid),
        jcfg.PSOConfig(**ROLLOUT_CFG), JMAP, interpret=True))(keys, hypo)
    tsnap = snapshot_from_numpy(world["snap"], "cpu")
    before = tro.pso_rollout.LAUNCHES
    got = tms.multi_swarm_rollout(
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(hypo), ROLLOUT_DEV, tsnap,
        torch.from_numpy(points), torch.from_numpy(valid), tcfg.PSOConfig(**ROLLOUT_CFG), TMAP)
    assert tro.pso_rollout.LAUNCHES == before  # CPU tensors never launch
    pose = got.pose.numpy()
    np.testing.assert_allclose(pose, np.asarray(ref.pose), atol=5e-3)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-4, atol=1e-3)
    assert np.abs(pose[:2] - inv[:2]).max() < 0.07 and abs(pose[2] - inv[2]) < 0.03
    exact = tcost.ndt_cost(got.pose[None], tsnap, torch.from_numpy(points),
                           torch.from_numpy(valid), TMAP)[0]
    np.testing.assert_allclose(float(got.cost), float(exact), rtol=1e-5)


def test_multi_swarm_rollout_modes_and_dtype(world):
    """score_dtype bf16 and rng_mode native take the rollout_bf16 and
    rollout_turbo kernel modes: each still relocalizes; a float64 caller
    gets float64 back; unknown modes are refused."""
    inv, keys, hypo, points, valid = _rollout_inputs(world)
    args = (torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(hypo).double(), ROLLOUT_DEV,
            snapshot_from_numpy(world["snap"], "cpu"), torch.from_numpy(points),
            torch.from_numpy(valid), tcfg.PSOConfig(**ROLLOUT_CFG), TMAP)
    for kw in (dict(score_dtype="bf16"), dict(rng_mode="native")):
        res = tms.multi_swarm_rollout(*args, **kw)
        assert res.pose.dtype == torch.float64
        pose = res.pose.numpy()
        assert np.abs(pose[:2] - inv[:2]).max() < 0.07 and abs(pose[2] - inv[2]) < 0.03, kw
    with pytest.raises(ValueError, match="unknown"):
        tms.multi_swarm_rollout(*args, rng_mode="philox")
    with pytest.raises(ValueError, match="needs the rank's mesh"):
        tms.multi_swarm_rollout(*args, axis_name="solves")
    alone = tms.multi_swarm_rollout(*args)
    got = tms.multi_swarm_rollout(*args, axis_name="solves", mesh=tmesh.make_mesh(device="cpu"))
    assert torch.equal(got.pose, alone.pose) and torch.equal(got.cost, alone.cost)


# ------------------------------------------------------ the cluster chooser

SMEM = 232448  # an H100's shared memory per block (opt-in)
# The clusters of C CTAs an H100 holds at once at K2 bf16's shape (B=16,
# P=4096, N=384), chip_smoke.py phase 5c: 132, 66, 30, 15 at C = 1, 2, 4, 8.
HELD = {1: 132, 2: 66, 4: 30, 8: 15}


@pytest.mark.parametrize("batch,waves,want", [
    (1, {1: 1, 2: 1, 4: 1, 8: 1}, 8),
    (3, {1: 1, 2: 1, 4: 1, 8: 1}, 8),
    (16, {1: 1, 2: 1, 4: 1, 8: 2}, 4),
    (256, {1: 2, 2: 4, 4: 9, 8: 18}, 1),
])
def test_cluster_chooser_by_waves(batch, waves, want):
    """The fewest waves, ceil(B / clusters held), then the largest C."""
    assert {c: _build.waves(batch, h) for c, h in HELD.items()} == waves
    need = lambda c: tro.smem_bytes(384, 4096, c)
    assert _build.choose_cluster(batch, need, SMEM, HELD.get) == want


def test_cluster_chooser_skips_what_does_not_fit_or_is_not_held():
    """A size whose CTA does not fit the shared memory is not queried; one
    the device cannot hold (0 clusters) is skipped; none left raises."""
    asked = []
    held = lambda c: asked.append(c) or {1: 0, 2: 66, 4: 30, 8: 15}[c]
    need = lambda c: trl.smem_bytes(384, 4096, c)  # C=1 does not fit
    assert _build.choose_cluster(256, need, SMEM, held) == 2
    assert 1 not in asked
    with pytest.raises(ValueError, match="no cluster size"):
        _build.choose_cluster(16, need, SMEM, lambda c: 0)


def test_device_cluster_caches_the_query(monkeypatch):
    """The occupancy query runs once per (kernel shape, batch, device): the
    main path's B=1 launch of every scan reads the cached choice.  A forced
    cluster never queries."""
    monkeypatch.setattr(_build, "CHOSEN", {})
    monkeypatch.setattr(_build, "device_limits", lambda index: (SMEM, 132))
    calls = []
    held = lambda c: calls.append(c) or HELD[c]
    need = lambda c: tro.smem_bytes(384, 4096, c)
    for _ in range(3):
        assert _build.device_cluster(("rollout", 384, 4096, False), 16, need, held, "cuda:0") == 4
    assert calls == [1, 2, 4, 8]
    assert _build.device_cluster(("rollout", 384, 4096, False), 1, need, held, "cuda:0") == 8
    assert _build.device_cluster(("rollout_local", 384, 4096, 2), 16, need, held, "cuda:0") == 4
    assert len(calls) == 12
    assert _build.device_cluster(("rollout", 384, 4096, False), 16, need, held, "cuda:0",
                                 cluster=8) == 8
    assert len(calls) == 12 and len(_build.CHOSEN) == 3


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _wide(world, dev, k=16, population=4096, iterations=10):
    """K2's inputs for a K-swarm relocalization of the rollout test's scan
    (hypotheses spread around its solution), points padded to N=384."""
    inv, _, _, points, valid = _rollout_inputs(world)
    rs = np.random.RandomState(11)
    keys = torch.from_numpy(rs.randint(0, 2**31, (k, 2)).astype(np.int64)).to(dev)
    hypo = torch.from_numpy(
        inv + rs.uniform(-1.0, 1.0, (k, 3)).astype(np.float32) * np.float32([1, 1, 0.1])).to(dev)
    pts = torch.zeros((384, 2), device=dev)
    pts[:N_PAD] = torch.from_numpy(points).to(dev)
    ok = torch.zeros(384, dtype=torch.bool, device=dev)
    ok[:N_PAD] = torch.from_numpy(valid).to(dev)
    snap = snapshot_from_numpy(world["snap"], dev)
    cfg = tcfg.PSOConfig(iterations=iterations, population=population)
    return keys, hypo, snap, pts, ok, cfg


@pytest.mark.gpu
def test_multi_swarm_rollout_kernel_matches_plain_on_gpu(world, cuda_device):
    """multi_swarm_rollout at K=16, P=4096, I=10 launches K2 once, at the
    chooser's C; K2 on the same packed inputs is held to its plain version
    summed in that cluster's order (the frozen-solve tolerance)."""
    keys, hypo, snap, pts, ok, cfg = _wide(world, cuda_device)
    before = tro.pso_rollout.LAUNCHES
    res = tms.multi_swarm_rollout(keys, hypo, ROLLOUT_DEV, snap, pts, ok, cfg, TMAP)
    torch.cuda.synchronize()
    assert tro.pso_rollout.LAUNCHES == before + 1 and torch.isfinite(res.pose).all()
    nbr = tcost.bind_neighborhood(hypo, snap, pts.expand(16, -1, -1), ok.expand(16, -1), TMAP)
    sten, packed = tro.pack_rollout_inputs(nbr, pts.expand(16, -1, -1))
    args = (keys, hypo, hypo.new_tensor(ROLLOUT_DEV).expand(16, 3), sten, packed, cfg, TMAP)
    kp, kc = tro.pso_rollout(*args)
    torch.cuda.synchronize()
    rp, rc = tro.pso_rollout_reference(*args, cluster=tro.pso_rollout.LAST_CLUSTER)
    np.testing.assert_allclose(kc.cpu().numpy(), rc.cpu().numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(kp.cpu().numpy(), rp.cpu().numpy(), atol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,want", [(1, 8), (3, 8), (16, 4)])
def test_chooser_on_the_card(world, cuda_device, batch, want):
    """On an H100 the chooser runs B=16 in one wave at C=4 (15 clusters of
    8 fit at once) and keeps C=8 at B=1 and B=3, for K2 (f32 and bf16) and
    K1's turbo branch at P=4096, N=384."""
    keys, hypo, snap, pts, ok, cfg = _wide(world, cuda_device, k=batch, iterations=2)
    nbr = tcost.bind_neighborhood(hypo, snap, pts.expand(batch, -1, -1), ok.expand(batch, -1), TMAP)
    devs = hypo.new_tensor(ROLLOUT_DEV).expand(batch, 3)
    sten, packed = tro.pack_rollout_inputs(nbr, pts.expand(batch, -1, -1))
    for kw in (dict(), dict(score_dtype="bf16")):
        tro.pso_rollout(keys, hypo, devs, sten, packed, cfg, TMAP, **kw)
        assert tro.pso_rollout.LAST_CLUSTER == want, kw
    lsten, lpacked = trl.pack_rollout_local_inputs(nbr, pts.expand(batch, -1, -1))
    trl.pso_rollout_local(keys, hypo, devs, lsten, lpacked, cfg, TMAP, rng_mode="native")
    torch.cuda.synchronize()
    assert trl.pso_rollout_local.LAST_CLUSTER == want
    held = tro.clusters_held(384, 4096, want, False, cuda_device)
    assert _build.waves(batch, held) == 1
