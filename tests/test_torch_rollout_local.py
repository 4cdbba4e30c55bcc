"""The port's rollout kernel module against the JAX package, on the CPU.

On the CPU, ``pso_rollout_local`` runs its plain PyTorch version; it is held
to the JAX Pallas kernel in interpret mode and to the JAX ``local_exact``
solve at rtol/atol 1e-5, the tolerance the JAX package holds its own kernel
to (tests/test_rollout.py): the point sums run in another order, and
sin/cos/exp differ in the last ulp between the two CPU libraries.

The kernel runs one solve per thread-block cluster of C CTAs and sums each
cost over a CTA's points, then over the CTAs in rank order; the chooser of C
and that sum order (``packed_stencil_cost(cluster=C)``) are held here.  The
CUDA kernel itself runs only on a GPU: the ``gpu``-marked tests compare it
with the plain version there, summed in the order of the kernel's cluster,
at every C, on ragged point counts, small batches, the early exit, P=8192
and 0.75 m cells (binning by division), and skip here.  The GPU machine has no JAX,
so the JAX comparisons skip there and the conftest (which imports JAX) is
left out; run it on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_rollout_local.py``.
"""

import time

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops import rollout_local as trl

try:
    import jax
    import jax.numpy as jnp

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import cost as jcost
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.ops import pallas_rollout as jpr
    from ndtpso_slam_tpu.parallel import mesh as jmesh

    JMAP = jcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
except ImportError:  # the GPU machine: no JAX, only the gpu test runs
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")

TMAP = tcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
N_PAD = 256


def _make_world(map_cfg):
    """The JAX package's rollout test world (an ellipse of 200 points mapped
    twice; the map is built by the port, which matches the JAX map bit for
    bit on the CPU, tests/test_torch_map.py) on map_cfg, its snapshot as
    numpy arrays, and a batch of 3 solves."""
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))).astype(np.float32)
    state = tmap.init_map(map_cfg, device="cpu")
    for _ in range(2):
        noisy = pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)
        tmap.add_points(state, map_cfg, torch.from_numpy(noisy), torch.ones(200, dtype=torch.bool))
        tmap.build(state, map_cfg)
    ts = tmap.snapshot(state, map_cfg)
    snap = dict(mean=ts.mean.numpy(), inv_cov=ts.inv_cov.numpy(), built=ts.built.numpy())
    b = 3
    rs = np.random.RandomState(1)
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32)
    guesses = rs.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
    devs = np.tile(np.float32([0.2, 0.2, 0.05]), (b, 1))
    points = np.zeros((b, N_PAD, 2), np.float32)
    points[:, :200] = pts[None]
    valid = np.zeros((b, N_PAD), bool)
    valid[:, :200] = True
    return dict(snap=snap, keys=keys, guesses=guesses, devs=devs, points=points, valid=valid,
                map=map_cfg)


@pytest.fixture(scope="module")
def world():
    """The rollout test world on TMAP's 1 m cells."""
    return _make_world(TMAP)


# A cell side that is not a power of two: the kernel bins by division there
# (by multiplication with the exact reciprocal for 0.5 m, 1 m, ...).
ODD_CELL_M = 0.75
TMAP_ODD = tcfg.MapConfig(size_m=24.0, cell_side_m=ODD_CELL_M, window_slots=4)


@pytest.fixture(scope="module")
def world_odd_cells():
    """The rollout test world on TMAP_ODD's 0.75 m cells."""
    return _make_world(TMAP_ODD)


def _tsnap(snap):
    return tmap.MapSnapshot(**{k: torch.from_numpy(v) for k, v in snap.items()})


def _jsnap(snap):
    return jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in snap.items()})


def _port_packed(world):
    tsnap = _tsnap(world["snap"])
    stens, ptss = [], []
    for g, p, v in zip(world["guesses"], world["points"], world["valid"]):
        nbr = tcost.bind_neighborhood(
            torch.from_numpy(g), tsnap, torch.from_numpy(p), torch.from_numpy(v), world["map"]
        )
        s, q = trl.pack_rollout_local_inputs(nbr, torch.from_numpy(p))
        stens.append(s)
        ptss.append(q)
    return torch.stack(stens), torch.stack(ptss)


def _jax_packed(world):
    nbrs = jax.vmap(
        lambda g, p, v: jcost.bind_neighborhood(g, _jsnap(world["snap"]), p, v, JMAP, radius=2)
    )(jnp.asarray(world["guesses"]), jnp.asarray(world["points"]), jnp.asarray(world["valid"]))
    return jax.vmap(jpr.pack_rollout_local_inputs)(nbrs, jnp.asarray(world["points"]))


@needs_jax
def test_pack_matches_jax(world):
    """Packing zeroes unbuilt lanes, so the packed tables agree although the
    JAX package binds this small map with its roll strategy and the port with
    a direct gather (the two differ only on unbuilt lanes)."""
    tsten, tpts = _port_packed(world)
    jsten, jpts = _jax_packed(world)
    assert tsten.shape == (3, 25, N_PAD, 8) and tpts.shape == (3, N_PAD, 8)
    np.testing.assert_array_equal(tsten.numpy(), np.asarray(jsten))
    np.testing.assert_array_equal(tpts.numpy(), np.asarray(jpts))
    assert (tsten[..., 5] == 0).any() and (tsten[..., 5] == trl.BIG).any()


@needs_jax
def test_bind_neighborhood_matches_on_built_lanes(world):
    tsnap = _tsnap(world["snap"])
    g, p, v = world["guesses"][0], world["points"][0], world["valid"][0]
    t = tcost.bind_neighborhood(torch.from_numpy(g), tsnap, torch.from_numpy(p), torch.from_numpy(v), TMAP)
    j = jcost.bind_neighborhood(jnp.asarray(g), _jsnap(world["snap"]), jnp.asarray(p), jnp.asarray(v), JMAP,
                                strategy="gather")
    np.testing.assert_array_equal(t.anchor_ix.numpy(), np.asarray(j.anchor_ix))
    np.testing.assert_array_equal(t.anchor_iy.numpy(), np.asarray(j.anchor_iy))
    np.testing.assert_array_equal(t.built.numpy(), np.asarray(j.built))
    b = t.built.numpy()
    np.testing.assert_array_equal(t.mean.numpy()[b], np.asarray(j.mean)[b])
    np.testing.assert_array_equal(t.icov.numpy()[b], np.asarray(j.icov)[b])


@needs_jax
@pytest.mark.parametrize("population", [50, 200])
def test_plain_rollout_matches_jax_kernel_and_local_exact(world, population):
    cfg_j = jcfg.PSOConfig(iterations=10, population=population)
    cfg_t = tcfg.PSOConfig(iterations=10, population=population)
    snaps = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (3,) + (1,) * x.ndim), _jsnap(world["snap"]))
    args = (world["keys"], world["guesses"], world["devs"], snaps, world["points"], world["valid"])
    r_kernel = jmesh.solve_batch(*args, JMAP, cfg_j, "rollout_local")  # Pallas, interpret mode
    r_exact = jmesh.solve_batch(*args, JMAP, cfg_j, "local_exact")
    sten, pts = _port_packed(world)
    before = trl.pso_rollout_local.LAUNCHES
    pose, cost = trl.pso_rollout_local(
        torch.from_numpy(world["keys"].astype(np.int64)), torch.from_numpy(world["guesses"]),
        torch.from_numpy(world["devs"]), sten, pts, cfg_t, TMAP,
    )
    assert trl.pso_rollout_local.LAUNCHES == before  # CPU tensors never launch
    for ref in (r_kernel, r_exact):
        np.testing.assert_allclose(cost.numpy(), np.asarray(ref.cost), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pose.numpy(), np.asarray(ref.pose), atol=1e-5)


def test_plain_rollout_equals_port_pso_over_stencil_exact_cost(world):
    """The plain version is pso_solve + stencil_exact_cost on the packed
    inputs: same draws, same cost bits."""
    from ndtpso_slam_tpu_torch.models.pso import pso_solve

    tsnap = _tsnap(world["snap"])
    cfg = tcfg.PSOConfig(iterations=8, population=50)
    sten, pts = _port_packed(world)
    pose, cost = trl.pso_rollout_local_reference(
        torch.from_numpy(world["keys"].astype(np.int64)), torch.from_numpy(world["guesses"]),
        torch.from_numpy(world["devs"]), sten, pts, cfg, TMAP,
    )
    for b in range(3):
        p = torch.from_numpy(world["points"][b])
        nbr = tcost.bind_neighborhood(
            torch.from_numpy(world["guesses"][b]), tsnap, p, torch.from_numpy(world["valid"][b]), TMAP
        )
        ref = pso_solve(
            tuple(int(k) for k in world["keys"][b]), torch.from_numpy(world["guesses"][b]),
            torch.from_numpy(world["devs"][b]),
            lambda poses, _bind: tcost.stencil_exact_cost(poses, nbr, p, TMAP), cfg,
        )
        np.testing.assert_array_equal(pose[b].numpy(), ref.pose.numpy())
        np.testing.assert_array_equal(cost[b].numpy(), ref.cost.numpy())


@needs_jax
def test_early_exit_matches_jax_kernel(world):
    """early_exit stops a solve once its best has stalled; both sides stop at
    the same iteration (JAX kernel in interpret mode)."""
    cfg_j = jcfg.PSOConfig(iterations=12, population=50)
    cfg_t = tcfg.PSOConfig(iterations=12, population=50)
    jsten, jpts = _jax_packed(world)
    jp, jc = jpr.pso_rollout_local(
        world["keys"], world["guesses"], world["devs"], jsten, jpts, cfg_j, JMAP,
        interpret=True, early_exit=2,
    )
    sten, pts = _port_packed(world)
    tp, tc = trl.pso_rollout_local(
        torch.from_numpy(world["keys"].astype(np.int64)), torch.from_numpy(world["guesses"]),
        torch.from_numpy(world["devs"]), sten, pts, cfg_t, TMAP, early_exit=2,
    )
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


@needs_jax
def test_select_min_first_argmin_and_nan():
    from ndtpso_slam_tpu.models import pso as jpso
    from ndtpso_slam_tpu_torch.models import pso as tpso

    cost = np.float32([[3, 1, 2, 1], [0, 0, 5, -1], [np.nan, 1, 0, 0]])
    pos = np.arange(36, dtype=np.float32).reshape(3, 4, 3)
    jm, jrow = jpso._select_min(jnp.asarray(cost), jnp.asarray(pos))
    tm, trow = tpso._select_min(torch.from_numpy(cost), torch.from_numpy(pos))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))


def test_wrapper_rejects_other_devices(world):
    sten, pts = _port_packed(world)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trl.pso_rollout_local(
            torch.zeros((3, 2), dtype=torch.int64, **meta), torch.zeros((3, 3), **meta),
            torch.zeros((3, 3), **meta), sten.to("meta"), pts.to("meta"),
            tcfg.PSOConfig(iterations=2, population=4), TMAP,
        )


# An H100's shared memory per block (opt-in), and the clusters of C CTAs it
# holds at once at one CTA per SM (chip_smoke.py phase 5c).
H100_SMEM = 232448
H100_HELD = {1: 132, 2: 66, 4: 30, 8: 15}.get


# C at P=4096 for B solves (rows) of N points (columns): the fewest waves,
# then the largest C (one wave of C=8 at B <= 15, of C=4 at B=16), and the
# fit of the table slice at B=256.
@pytest.mark.parametrize("batch,n_pts,want", [
    (b, n, c) for b, row in ((1, (8, 8, 8)), (3, (8, 8, 8)), (16, (4, 4, 4)), (256, (1, 2, 4)))
    for n, c in zip((100, 384, 1024), row)
])
def test_cluster_chooser_table(batch, n_pts, want):
    need = lambda c: trl.smem_bytes(n_pts, 4096, c)
    assert _build.choose_cluster(batch, need, H100_SMEM, H100_HELD) == want


def test_cluster_chooser_raises_when_nothing_fits():
    """N=2048, P=8192: even an eighth of the table does not fit a CTA."""
    with pytest.raises(ValueError, match="no cluster size"):
        _build.choose_cluster(256, lambda c: trl.smem_bytes(2048, 8192, c), H100_SMEM, H100_HELD)


def _poses(world, n=64, seed=4):
    rs = np.random.RandomState(seed)
    return (world["guesses"][0] + rs.uniform(-0.3, 0.3, (n, 3)) * [1.0, 1.0, 0.2]).astype(np.float32)


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_rank_sliced_cost_matches_plain_and_jax(world, cluster):
    """The kernel's sum order on C CTAs (per-rank partials, then rank order)
    against the plain one-pass sum and the JAX stencil_exact_cost, at the
    1e-5 tolerance of this file."""
    sten, pts = _port_packed(world)
    poses = torch.from_numpy(_poses(world))
    sliced = trl.packed_stencil_cost(poses, sten[0], pts[0], TMAP, 2, cluster=cluster)
    plain = trl.packed_stencil_cost(poses, sten[0], pts[0], TMAP, 2)
    assert (sliced < 0).sum() > 32
    np.testing.assert_allclose(sliced.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    if jax is not None:
        g, p, v = world["guesses"][0], world["points"][0], world["valid"][0]
        nbr = jcost.bind_neighborhood(jnp.asarray(g), _jsnap(world["snap"]), jnp.asarray(p),
                                      jnp.asarray(v), JMAP, radius=2)
        # Op by op: XLA's fusion of the whole cost moves it by ~1e-5.
        ref = jcost.stencil_exact_cost(jnp.asarray(poses.numpy()), nbr, jnp.asarray(p), JMAP)
        np.testing.assert_allclose(sliced.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cluster", [2, 8])
def test_plain_rollout_in_cluster_order(world, cluster):
    """On the CPU, cluster=C runs the plain version with the kernel's sum
    order on C CTAs (the order the gpu tests hold the kernel to); it leaves
    the solve where the one-pass order takes it, within this file's
    tolerances."""
    cfg = tcfg.PSOConfig(iterations=8, population=50)
    sten, pts = _port_packed(world)
    args = (torch.from_numpy(world["keys"].astype(np.int64)), torch.from_numpy(world["guesses"]),
            torch.from_numpy(world["devs"]), sten, pts, cfg, TMAP)
    p1, c1 = trl.pso_rollout_local(*args)
    pc, cc = trl.pso_rollout_local(*args, cluster=cluster)
    ref = trl.pso_rollout_local_reference(*args, cluster=cluster)
    assert torch.equal(cc, ref[1]) and torch.equal(pc, ref[0])
    np.testing.assert_allclose(cc.numpy(), c1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pc.numpy(), p1.numpy(), atol=1e-5)


@needs_jax
def test_plain_rollout_on_odd_cells_matches_jax_kernel(world_odd_cells):
    """On 0.75 m cells (binning by division in the kernel), the plain
    version against the JAX Pallas kernel in interpret mode."""
    jmap_odd = jcfg.MapConfig(size_m=24.0, cell_side_m=ODD_CELL_M, window_slots=4)
    w = world_odd_cells
    cfg_j = jcfg.PSOConfig(iterations=10, population=50)
    snaps = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (3,) + (1,) * x.ndim), _jsnap(w["snap"]))
    ref = jmesh.solve_batch(w["keys"], w["guesses"], w["devs"], snaps, w["points"], w["valid"],
                            jmap_odd, cfg_j, "rollout_local")
    sten, pts = _port_packed(w)
    pose, cost = trl.pso_rollout_local(
        torch.from_numpy(w["keys"].astype(np.int64)), torch.from_numpy(w["guesses"]),
        torch.from_numpy(w["devs"]), sten, pts, tcfg.PSOConfig(iterations=10, population=50),
        TMAP_ODD,
    )
    assert (cost < -50.0).all()
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref.cost), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref.pose), atol=1e-5)


def _padded(sten, pts, n, multiple):
    """The first n points padded with masked points to a multiple of
    `multiple`: zero point rows (valid 0) and unbuilt stencil rows."""
    pad = -n % multiple
    sten_p = torch.zeros((sten.shape[0], sten.shape[1], pad, 8))
    sten_p[..., 5] = trl.BIG
    return (torch.cat([sten[:, :, :n], sten_p], dim=2),
            torch.cat([pts[:, :n], torch.zeros((pts.shape[0], pad, 8))], dim=1))


def test_padded_points_score_zero_and_leave_the_solve(world):
    """Points past N (a ragged N=203 padded to a multiple of C=8) score
    exactly 0 and leave the solve as it was."""
    sten, pts = _port_packed(world)
    psten, ppts = _padded(sten, pts, 203, 8)
    assert ppts.shape[1] == 208
    poses = torch.from_numpy(_poses(world))
    pad_only = trl.packed_stencil_cost(poses, psten[0, :, 203:], ppts[0, 203:], TMAP, 2)
    assert torch.equal(pad_only, torch.zeros_like(pad_only))
    cfg = tcfg.PSOConfig(iterations=6, population=50)
    args = (torch.from_numpy(world["keys"].astype(np.int64)), torch.from_numpy(world["guesses"]),
            torch.from_numpy(world["devs"]))
    p0, c0 = trl.pso_rollout_local(*args, sten[:, :, :203], pts[:, :203], cfg, TMAP)
    p1, c1 = trl.pso_rollout_local(*args, psten, ppts, cfg, TMAP)
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the rollout kernel has no CPU mode")
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


def _gpu_args(world, dev, sten, pts, solves, cfg):
    """Kernel arguments for the world's solves `solves` (indices into its 3),
    on dev."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(world["keys"].astype(np.int64)[solves]), t(world["guesses"][solves]),
            t(world["devs"][solves]), sten[solves].to(dev), pts[solves].to(dev), cfg,
            world["map"])


def _check_kernel(args, cluster=None, **kw):
    """The kernel against its plain version with the point sums in the order
    of the cluster the kernel ran on.  Returns that cluster's size and the
    plain cost."""
    before = trl.pso_rollout_local.LAUNCHES
    kp, kc = trl.pso_rollout_local(*args, cluster=cluster, **kw)
    synced()
    assert trl.pso_rollout_local.LAUNCHES == before + 1
    ran_on = trl.pso_rollout_local.LAST_CLUSTER
    rp, rc = trl.pso_rollout_local_reference(*args, cluster=ran_on, **kw)
    np.testing.assert_allclose(kc.cpu().numpy(), rc.cpu().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kp.cpu().numpy(), rp.cpu().numpy(), atol=1e-5)
    return ran_on, rc


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("population", [50, 200])
def test_kernel_matches_plain_on_gpu(world, cuda_device, population, cluster):
    """The CUDA kernel against its plain version on the same card tensors,
    on clusters of every size (None: the chooser's, 8 at B=3).  Costs to
    float32 sum-order error (rtol 1e-5); poses from identical draws and
    decisions (atol 1e-5)."""
    cfg = tcfg.PSOConfig(iterations=10, population=population)
    sten, pts = _port_packed(world)
    args = _gpu_args(world, cuda_device, sten, pts, [0, 1, 2], cfg)
    assert _check_kernel(args, cluster)[0] == (cluster or 8)


@pytest.mark.gpu
@pytest.mark.parametrize("rng_mode", ["threefry", "native"])
def test_kernel_bins_odd_cells_on_gpu(world_odd_cells, cuda_device, rng_mode):
    """0.75 m cells, not a power of two: the kernel bins by dividing by the
    cell side there, and is held to its plain version at this file's
    tolerances, with most points scoring."""
    cfg = tcfg.PSOConfig(iterations=10, population=50)
    sten, pts = _port_packed(world_odd_cells)
    args = _gpu_args(world_odd_cells, cuda_device, sten, pts, [0, 1, 2], cfg)
    _, cost = _check_kernel(args, rng_mode=rng_mode)
    assert (cost.cpu() < -50.0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("early_exit", [0, 2])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_kernel_ragged_points_and_batches_on_gpu(world, cuda_device, batch, early_exit):
    """N=100 (not a multiple of C: the last CTA's slice is short), B in
    {1, 3, 16}, with and without the early exit, which every CTA of a
    cluster must take at the same iteration."""
    cfg = tcfg.PSOConfig(iterations=12, population=64)
    sten, pts = _port_packed(world)
    solves = np.arange(batch) % 3
    args = _gpu_args(world, cuda_device, sten[:, :, :100], pts[:, :100], solves, cfg)
    for cluster in (None, 4):
        _check_kernel(args, cluster, early_exit=early_exit)
    _check_kernel(args, None, early_exit=early_exit, rng_mode="native")


@pytest.mark.gpu
def test_kernel_takes_8192_particles_on_gpu(world, cuda_device):
    """P=8192, 16 particles per thread, which a CTA with the particle state
    in shared memory could not hold."""
    cfg = tcfg.PSOConfig(iterations=3, population=8192)
    sten, pts = _port_packed(world)
    args = _gpu_args(world, cuda_device, sten, pts, [0], cfg)
    assert _check_kernel(args)[0] == 8


@pytest.mark.gpu
def test_kernel_smem_matches_its_plain_formula_on_gpu(cuda_device):
    lib = _build.load(trl.LIB)
    for n, p, c in ((100, 50, 8), (384, 4096, 2), (1024, 8192, 8), (5, 1, 4), (384, 8193, 2),
                    (384, 16384, 8)):
        assert lib.ndt_rollout_local_smem_bytes(n, p, c, 2) == trl.smem_bytes(n, p, c)
        assert lib.ndt_rollout_local_slice_floats(p) == _build.slice_floats(p)
    assert lib.ndt_rollout_local_max_population() == trl.MAX_POPULATION
