"""The port's rollout kernel module against the JAX package, on the CPU.

On the CPU, ``pso_rollout_local`` runs its plain PyTorch version; it is held
to the JAX Pallas kernel in interpret mode and to the JAX ``local_exact``
solve at rtol/atol 1e-5, the tolerance the JAX package holds its own kernel
to (tests/test_rollout.py): the point sums run in another order, and
sin/cos/exp differ in the last ulp between the two CPU libraries.

The CUDA kernel itself runs only on a GPU: the ``gpu``-marked test compares
it with the plain version there and skips here.  The GPU machine has no JAX,
so the JAX comparisons skip there and the conftest (which imports JAX) is
left out; run it on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_rollout_local.py``.
"""

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
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


@pytest.fixture(scope="module")
def world():
    """The JAX package's rollout test world (an ellipse of 200 points mapped
    twice; the map is built by the port, which matches the JAX map bit for
    bit on the CPU, tests/test_torch_map.py), its snapshot as numpy arrays,
    and a batch of 3 solves."""
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
    b = 3
    rs = np.random.RandomState(1)
    keys = rs.randint(0, 2**31, (b, 2)).astype(np.uint32)
    guesses = rs.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
    devs = np.tile(np.float32([0.2, 0.2, 0.05]), (b, 1))
    points = np.zeros((b, N_PAD, 2), np.float32)
    points[:, :200] = pts[None]
    valid = np.zeros((b, N_PAD), bool)
    valid[:, :200] = True
    return dict(snap=snap, keys=keys, guesses=guesses, devs=devs, points=points, valid=valid)


def _tsnap(snap):
    return tmap.MapSnapshot(**{k: torch.from_numpy(v) for k, v in snap.items()})


def _jsnap(snap):
    return jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in snap.items()})


def _port_packed(world):
    tsnap = _tsnap(world["snap"])
    stens, ptss = [], []
    for g, p, v in zip(world["guesses"], world["points"], world["valid"]):
        nbr = tcost.bind_neighborhood(
            torch.from_numpy(g), tsnap, torch.from_numpy(p), torch.from_numpy(v), TMAP
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the rollout kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("population", [50, 200])
def test_kernel_matches_plain_on_gpu(world, cuda_device, population):
    """The CUDA kernel against its plain version on the same card tensors.
    Costs to float32 sum-order error (rtol 1e-5); poses from identical draws
    and decisions (atol 1e-5)."""
    cfg = tcfg.PSOConfig(iterations=10, population=population)
    sten, pts = _port_packed(world)
    args = (
        torch.from_numpy(world["keys"].astype(np.int64)).to(cuda_device),
        torch.from_numpy(world["guesses"]).to(cuda_device),
        torch.from_numpy(world["devs"]).to(cuda_device),
        sten.to(cuda_device), pts.to(cuda_device), cfg, TMAP,
    )
    before = trl.pso_rollout_local.LAUNCHES
    kp, kc = trl.pso_rollout_local(*args)
    torch.cuda.synchronize()
    assert trl.pso_rollout_local.LAUNCHES == before + 1
    rp, rc = trl.pso_rollout_local_reference(*args)
    np.testing.assert_allclose(kc.cpu().numpy(), rc.cpu().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kp.cpu().numpy(), rp.cpu().numpy(), atol=1e-5)
