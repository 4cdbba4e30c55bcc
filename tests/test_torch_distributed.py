"""The port's multi-device and multi-process runtime (parallel/runtime.py,
parallel/distributed.py, the sharded entry points of parallel/mesh.py,
multi_swarm.py and fleet.py) on the CPU: mirrors of tests/test_parallel.py
and tests/test_distributed_runtime.py.

Two kinds of test:

* in-process at world 1 (nothing initialized: every mesh is one rank), held
  to the JAX package's sharded calls on its 8-device virtual mesh;
* a 2 x 2 (hosts x chips) world of 4 CPU processes over gloo
  (tests/torch_distributed_worker.py, run once per module, one thread each),
  whose results are held to the port's unsharded calls and to the JAX
  package.

Tolerances, with their reasons:

* against the port's unsharded calls: bit for bit (each rank runs the same
  arithmetic on its rows; a merge gathers exact values), except the map
  merge's float accumulators, summed in another order across ranks:
  ``cur_sum`` within 1e-4 and ``g_sum`` within 1e-5, the integer fields and
  flags bit for bit (tests/test_parallel.py:141-155,
  tests/distributed_worker.py:189-192);
* against the JAX package: tests/test_torch_batch.py's ``_TOL`` per cost
  mode, tests/test_torch_multi_swarm.py's tolerances for the exchange
  (exact cost: poses 1e-5, costs rtol 1e-5; rollout: K2's frozen-solve
  tolerances), tests/test_torch_fleet.py's ``TRAJ_ATOL`` for the fleet;
* the merge's tie order: equal to the JAX package's ``all_gather`` order.

The ``gpu`` tests (the same worker as 2 ranks on ``cuda:0`` over gloo, and
one rank over NCCL) skip here.  The GPU machine has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_distributed.py``.
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import torch_distributed_worker as W
from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import pso as tpso
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.parallel import distributed, fleet, multi_swarm, runtime
from ndtpso_slam_tpu_torch.parallel import mesh as tmesh

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as JP

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import cost as jcost
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.models import scan as jscan
    from ndtpso_slam_tpu.models import slam as jslam
    from ndtpso_slam_tpu.parallel import distributed as jdist
    from ndtpso_slam_tpu.parallel import fleet as jfleet
    from ndtpso_slam_tpu.parallel import mesh as jmesh
    from ndtpso_slam_tpu.parallel import multi_swarm as jms

    JMAP = jcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
    JPSO = jcfg.PSOConfig(iterations=W.PSO_CFG.iterations, population=W.PSO_CFG.population)
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package (the reference)")

HOSTS, CHIPS = 2, 2
RANKS = HOSTS * CHIPS
RANK_TIMEOUT_S = 300
_EXACT = (1e-5, 1e-5, 1e-5)
_FROZEN = (1e-4, 1e-3, 5e-3)
# tests/test_torch_batch.py's _TOL for the modes the worker runs.
_TOL = {"fast": _FROZEN, "rollout_local": _EXACT, "rollout": _FROZEN, "fast_fused": _FROZEN}
TRAJ_ATOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tests/test_torch_fleet.py:one_thread's reason)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(out_dir, device, hosts, chips, backend=None):
    """The worker as hosts x chips ranks; each waits on its own timeout.
    Returns each rank's npz, rank order."""
    port, root = _free_port(), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(hosts * chips):
        env = dict(os.environ, NDTPSO_COORDINATOR=f"localhost:{port}",
                   NDTPSO_NUM_PROCESSES=str(hosts * chips), NDTPSO_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1", PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, os.path.join(root, "tests", "torch_distributed_worker.py"),
               out_dir, device, str(hosts), str(chips)] + ([backend] if backend else [])
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0 and f"[rank {r}] WORKER OK" in out, \
                f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(hosts * chips)]


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        return _run_world(tmp, "cpu", HOSTS, CHIPS)


@pytest.fixture(scope="module")
def x():
    return W.inputs()


def _rows(r, n=W.B, ranks=RANKS):
    return slice(r * n // ranks, (r + 1) * n // ranks)


def _cpu_mesh(shape=(HOSTS, CHIPS), rank=0):
    """A mesh as rank ``rank`` sees it, without a process group (for its
    orders only)."""
    return runtime.Mesh(runtime.SOLVE_AXES, shape, torch.device("cpu"), rank)


# ---------------------------------------------- in process, world 1

def test_distributed_config_precedence(monkeypatch):
    for name in ("NDTPSO_COORDINATOR", "NDTPSO_NUM_PROCESSES", "NDTPSO_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert runtime.distributed_config() is None
    assert runtime.initialize_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert runtime.distributed_config() == ("localhost:1234", 4, 3)
    monkeypatch.setenv("NDTPSO_COORDINATOR", "h:9")
    monkeypatch.setenv("NDTPSO_NUM_PROCESSES", "2")
    monkeypatch.setenv("NDTPSO_PROCESS_ID", "1")
    assert runtime.distributed_config() == ("h:9", 2, 1)
    assert runtime.distributed_config("a:1", 8, 5) == ("a:1", 8, 5)
    monkeypatch.delenv("NDTPSO_PROCESS_ID")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="incomplete"):
        runtime.distributed_config()


def test_world_one_meshes_and_rows():
    flat = tmesh.make_mesh(device="cpu")
    hier = runtime.make_hier_mesh(device="cpu")
    assert (flat.axes, flat.shape, hier.axes, hier.shape) == (("solves",), (1,), runtime.SOLVE_AXES, (1, 1))
    with pytest.raises(ValueError, match="needs 8 ranks"):
        tmesh.make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        runtime.make_hier_mesh(2, 1, device="cpu")
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(runtime.shard_rows(hier, x), x)
    assert torch.equal(runtime.gather_global(hier, x), x)
    assert torch.equal(runtime.all_reduce(hier, x, runtime.ICI_AXIS), x)
    assert not hier.routes  # no collective ran
    with pytest.raises(ValueError, match="not distinct axes"):
        runtime.shard_rows(flat, x, runtime.SOLVE_AXES)
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        runtime.shard_rows(_cpu_mesh(), x)
    assert torch.equal(runtime.shard_rows(_cpu_mesh(rank=3), torch.arange(8)), torch.tensor([6, 7]))


@needs_jax
@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
def test_gather_order_is_jax_all_gather_order(shape):
    """Mesh.members orders a tuple of axes as jax.lax.all_gather does on the
    virtual mesh: the first axis named outermost."""
    mesh = JMesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), runtime.SOLVE_AXES)
    orders = (("chips", "hosts"), ("hosts", "chips"), ("chips",), ("hosts",))

    def gathered(v):
        rank = (jax.lax.axis_index("hosts") * shape[1] + jax.lax.axis_index("chips")).astype(jnp.int32)
        return tuple(jax.lax.all_gather(rank, axes, tiled=False).reshape(1, -1) for axes in orders)

    out = jax.jit(jax.shard_map(gathered, mesh=mesh, in_specs=JP(runtime.SOLVE_AXES),
                                out_specs=JP(runtime.SOLVE_AXES), check_vma=False))(
        jnp.zeros(shape[0] * shape[1]))
    for r in range(shape[0] * shape[1]):
        for axes, got in zip(orders, out):
            assert _cpu_mesh(shape, r).members(axes) == np.asarray(got)[r].tolist(), (r, axes)


def _jpoints(x):
    points, valid = W.padded(x)
    return np.tile(points[None], (W.B, 1, 1)), np.tile(valid[None], (W.B, 1))


def _jsnaps(x):
    return jmap.MapSnapshot(**{k: jnp.asarray(np.broadcast_to(v, (W.B,) + v.shape))
                               for k, v in x["snap"].items()})


@needs_jax
@pytest.mark.parametrize("shared_map", [False, True])
def test_world_one_solve_batch_sharded(x, shared_map):
    """solve_batch_sharded at world 1 is solve_batch, bit for bit, and holds
    the JAX solve_batch_sharded on the 8-device virtual mesh to fast's
    _TOL."""
    keys, guesses, devs, snaps, points, valid = W.solve_args(x, "cpu")
    if shared_map:
        snaps = tmap.MapSnapshot(**{k: torch.from_numpy(v) for k, v in x["snap"].items()})
    got = tmesh.solve_batch_sharded(tmesh.make_mesh(device="cpu"), keys, guesses, devs, snaps,
                                    points, valid, W.MAP_CFG, W.PSO_CFG, "fast", shared_map)
    ref = tmesh.solve_batch(keys, guesses, devs, snaps, points, valid, W.MAP_CFG, W.PSO_CFG, "fast")
    assert torch.equal(got.pose, ref.pose) and torch.equal(got.cost, ref.cost)
    jsnap = (jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in x["snap"].items()}) if shared_map
             else _jsnaps(x))
    jref = jmesh.solve_batch_sharded(
        jmesh.make_mesh(8), x["keys"].astype(np.uint32), x["guesses"], np.tile(W.DEV, (W.B, 1)),
        jsnap, *_jpoints(x), JMAP, JPSO, "fast", shared_map=shared_map)
    crtol, catol, patol = _TOL["fast"]
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(jref.pose), atol=patol)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(jref.cost), rtol=crtol, atol=catol)


def _jmap_state(port_map):
    """The JAX map of a port map's numpy fields: the real rows, no spare."""
    c = JMAP.num_cells
    st = jmap.init_map(JMAP)
    return st.replace(**{f: jnp.asarray(v[:c]) for f, v in port_map.items()})


def _jax_serial_merge(x):
    """The JAX package's serial ingestion of the merge scans (update, then
    build), and its state before the last build."""
    st, last = _jmap_state(x["map"]), None
    for s in range(W.MERGE_SCANS):
        st = jmap.update(st, JMAP, jnp.asarray(x["merge_poses"][s]), jnp.asarray(x["merge_pts"][s]),
                         jnp.ones(160, bool))
        last = st
        st = jmap.build(st, JMAP)
    return last, st


def _check_merged(got, want, c=W.MAP_CFG.num_cells):
    """The merge contract: integer fields and flags bit for bit, cur_sum
    within 1e-4, g_sum within 1e-5 (over the real rows)."""
    for f in ("cur_count", "created", "built", "g_count", "slot_idx", "rot_count", "slot_count"):
        if f in got and f in want:
            np.testing.assert_array_equal(np.asarray(got[f])[:c], np.asarray(want[f])[:c], err_msg=f)
    for f, tol in (("cur_sum", 1e-4), ("g_sum", 1e-5)):
        if f in got and f in want:
            np.testing.assert_allclose(np.asarray(got[f])[:c], np.asarray(want[f])[:c], atol=tol,
                                       rtol=0, err_msg=f)


@needs_jax
def test_world_one_merge_matches_jax_sharded_update(x):
    """sharded_update at world 1 (before + the one rank's delta) holds update
    and the JAX sharded_update over its 8 virtual devices (each ingesting 20
    points, psum-merged) under the merge contract; cur_m2, which the
    contract does not name, within cur_sum's 1e-4."""
    mesh = tmesh.make_mesh(device="cpu")
    pts, pose = torch.from_numpy(x["merge_pts"][1]), torch.from_numpy(x["merge_poses"][1])
    valid = torch.ones(160, dtype=torch.bool)
    got = distributed.sharded_update(W.map_state(x, "cpu"), W.MAP_CFG, pose, pts, valid, mesh,
                                     "solves")
    ref = tmap.update(W.map_state(x, "cpu"), W.MAP_CFG, pose, pts, valid)
    _check_merged({f: getattr(got, f).numpy() for f in distributed.MERGED_FIELDS},
                  {f: getattr(ref, f).numpy() for f in distributed.MERGED_FIELDS})
    np.testing.assert_allclose(got.cur_m2.numpy(), ref.cur_m2.numpy(), atol=1e-4, rtol=0)
    jm = jmesh.make_mesh(8)
    run = lambda st, p, v: jdist.sharded_update(st, JMAP, jnp.asarray(x["merge_poses"][1]), p, v,
                                                jmesh.SOLVE_AXIS)
    jgot = jax.jit(jax.shard_map(run, mesh=jm, in_specs=(JP(), JP("solves"), JP("solves")),
                                 out_specs=JP(), check_vma=False))(
        _jmap_state(x["map"]), jnp.asarray(x["merge_pts"][1]), jnp.ones(160, bool))
    want = {f: np.asarray(getattr(jgot, f)) for f in distributed.MERGED_FIELDS}
    _check_merged({f: getattr(got, f).numpy() for f in distributed.MERGED_FIELDS}, want)
    np.testing.assert_allclose(got.cur_m2.numpy()[:-1], want["cur_m2"], atol=1e-4, rtol=0)
    tmap.build(got, W.MAP_CFG)
    jb = jmap.build(jgot, JMAP)
    _check_merged({"g_sum": got.g_sum.numpy(), "g_count": got.g_count.numpy()},
                  {"g_sum": np.asarray(jb.g_sum), "g_count": np.asarray(jb.g_count)})


def test_world_one_exchange_and_fleet_are_the_unsharded_calls(x):
    """At world 1 the merges over a mesh axis gather one rank: the sharded
    multi-swarm and fleet equal their unsharded calls bit for bit; an axis
    without a mesh is refused."""
    mesh = runtime.make_hier_mesh(device="cpu")
    keys, guesses = torch.from_numpy(x["sw_keys"]), torch.from_numpy(x["sw_guesses"])
    cost = W.exact_cost(x, "cpu")
    kw = dict(exchange_every=2)
    got = multi_swarm.multi_swarm_solve(keys, guesses, W.DEV, cost, W.PSO_CFG, axis_name="chips",
                                        dcn_axis_name="hosts", dcn_exchange_every=4, mesh=mesh, **kw)
    ref = multi_swarm.multi_swarm_solve(keys, guesses, W.DEV, cost, W.PSO_CFG, **kw)
    assert torch.equal(got.pose, ref.pose) and torch.equal(got.cost, ref.cost)
    with pytest.raises(ValueError, match="needs the rank's mesh"):
        multi_swarm.multi_swarm_solve(keys, guesses, W.DEV, cost, W.PSO_CFG, axis_name="chips")
    cfg = W.fleet_cfg()
    scans = tscan.Scan(points=torch.from_numpy(x["fleet_points"][:2, :3]),
                       valid=torch.from_numpy(x["fleet_valid"][:2, :3]))
    _, poses, costs = fleet.run_offline_fleet_sharded(
        tmesh.make_mesh(device="cpu"), tslam.init_slam_batch(cfg, x["fleet_init"][:2], "cpu"),
        scans, x["fleet_keys"][:2], cfg)
    _, rposes, rcosts = fleet.run_offline_fleet(
        tslam.init_slam_batch(cfg, x["fleet_init"][:2], "cpu"), scans, x["fleet_keys"][:2], cfg)
    assert torch.equal(poses, rposes) and torch.equal(costs, rcosts)
    with pytest.raises(ValueError, match="not distinct axes"):
        fleet.make_fleet_sharded(mesh, cfg, axis="solves")


# ------------------------------------------ 2 x 2 ranks over gloo (CPU)

def test_ranks_ran_gloo_on_the_cpu(ranks):
    for r, out in enumerate(ranks):
        assert str(out["device"]) == "cpu" and str(out["backend"]) == "gloo", r
        routes = {" ".join(line.split()[:3]) for line in out["routes"]}
        assert routes == {"all_gather gloo cpu", "all_reduce gloo cpu"}, routes


@pytest.mark.parametrize("mode", W.MODES)
def test_dp_solves_match_unsharded(x, ranks, mode):
    """Each rank's rows of the hierarchy's solve are solve_batch's rows, bit
    for bit, and every rank gathers the whole batch in rank order."""
    ref = tmesh.solve_batch(*W.solve_args(x, "cpu"), W.MAP_CFG, W.PSO_CFG, mode)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"dp_{mode}_pose"], ref.pose.numpy()[_rows(r)])
        np.testing.assert_array_equal(out[f"dp_{mode}_cost"], ref.cost.numpy()[_rows(r)])
        np.testing.assert_array_equal(out[f"dp_{mode}_gathered"], ref.pose.numpy())
        assert not out[f"dp_{mode}_launches"].any()  # CPU tensors never launch


@needs_jax
@pytest.mark.parametrize("mode", W.MODES)
def test_dp_solves_match_jax(x, ranks, mode):
    jref = jmesh.solve_batch(x["keys"].astype(np.uint32), x["guesses"], np.tile(W.DEV, (W.B, 1)),
                             _jsnaps(x), *_jpoints(x), JMAP, JPSO, mode)
    pose = np.concatenate([out[f"dp_{mode}_pose"] for out in ranks])
    cost = np.concatenate([out[f"dp_{mode}_cost"] for out in ranks])
    crtol, catol, patol = _TOL[mode]
    np.testing.assert_allclose(pose, np.asarray(jref.pose), atol=patol)
    np.testing.assert_allclose(cost, np.asarray(jref.cost), rtol=crtol, atol=catol)


def test_shared_map_solves_match_unsharded(x, ranks):
    keys, guesses, devs, _, points, valid = W.solve_args(x, "cpu")
    snap = tmap.MapSnapshot(**{k: torch.from_numpy(v) for k, v in x["snap"].items()})
    ref = tmesh.solve_batch(keys, guesses, devs, snap, points, valid, W.MAP_CFG, W.PSO_CFG, "fast")
    for out in ranks:
        np.testing.assert_array_equal(out["shared_pose"], ref.pose.numpy())
        np.testing.assert_array_equal(out["shared_cost"], ref.cost.numpy())


def _emulated_two_tier(x, every, dcn_every, hosts=HOSTS, chips=CHIPS):
    """All K swarms in one process with the hierarchy's merges written out:
    every ``every`` iterations the first minimum over each host's swarms,
    every ``dcn_every`` over all of them, ranks taken chips-major (the
    order of JAX's gather over ('chips', 'hosts')), and a final merge over
    all."""
    k = W.B
    per = k // (hosts * chips)

    def merge(gbest, cost, groups):
        pose, best = gbest.clone(), cost.clone()
        for ranks in groups:
            rows = [tpso._select_min(cost[r * per:(r + 1) * per], gbest[r * per:(r + 1) * per])
                    for r in ranks]
            c, p = tpso._select_min(torch.stack([c for c, _ in rows]),
                                    torch.stack([p for _, p in rows]))
            for r in ranks:
                pose[r * per:(r + 1) * per], best[r * per:(r + 1) * per] = p, c
        return pose, best

    hosts_groups = [[h * chips + c for c in range(chips)] for h in range(hosts)]
    everything = [[h * chips + c for c in range(chips) for h in range(hosts)]]

    def exchange(i, gbest, cost):
        if (i + 1) % dcn_every == 0:
            return merge(gbest, cost, everything)
        if (i + 1) % every == 0:
            return merge(gbest, cost, hosts_groups)
        return None

    res = tpso.pso_solve_batch(torch.from_numpy(x["sw_keys"]), torch.from_numpy(x["sw_guesses"]),
                               torch.from_numpy(np.tile(W.DEV, (k, 1))), W.exact_cost(x, "cpu"),
                               W.PSO_CFG, exchange=exchange)
    pose, cost = merge(res.pose, res.cost, everything)
    return pose[0], cost[0]


def test_two_tier_exchange_matches_the_emulated_hierarchy(x, ranks):
    """The two-tier exchange (every 2 iterations within a host, every 4
    across hosts) against all K swarms in one process at the same cadence,
    bit for bit, on every rank."""
    pose, cost = _emulated_two_tier(x, *W.EXCHANGE)
    for out in ranks:
        np.testing.assert_array_equal(out["ms_two_tier_pose"], pose.numpy())
        np.testing.assert_array_equal(out["ms_two_tier_cost"], cost.numpy())


def test_global_exchange_matches_full_k(x, ranks):
    """With every merge across hosts (dcn_exchange_every = exchange_every =
    2) the sharded islands are the full-K run at exchange 2, bit for bit
    (tests/distributed_worker.py's case)."""
    ref = multi_swarm.multi_swarm_solve(torch.from_numpy(x["sw_keys"]),
                                        torch.from_numpy(x["sw_guesses"]), W.DEV,
                                        W.exact_cost(x, "cpu"), W.PSO_CFG, exchange_every=2)
    for out in ranks:
        np.testing.assert_array_equal(out["ms_global_pose"], ref.pose.numpy())
        np.testing.assert_array_equal(out["ms_global_cost"], ref.cost.numpy())


def _jax_mesh22():
    return JMesh(np.array(jax.devices()[:RANKS]).reshape(HOSTS, CHIPS), runtime.SOLVE_AXES)


@needs_jax
def test_two_tier_exchange_matches_jax(x, ranks):
    """The JAX multi_swarm_solve sharded over a 2 x 2 virtual mesh at the
    same cadence, exact cost: poses 1e-5, costs rtol 1e-5."""
    snap = jmap.MapSnapshot(**{k: jnp.asarray(v) for k, v in x["snap"].items()})
    pts, valid = jnp.asarray(x["pts"]), jnp.ones(200, bool)
    cost_fn = lambda poses, bind: jcost.ndt_cost(poses, snap, pts, valid, JMAP)

    def run(k, g):
        r = jms.multi_swarm_solve(k, g, jnp.asarray(W.DEV), cost_fn, JPSO,
                                  exchange_every=W.EXCHANGE[0], axis_name="chips",
                                  dcn_axis_name="hosts", dcn_exchange_every=W.EXCHANGE[1])
        return r.pose, r.cost

    pose, cost = jax.jit(jax.shard_map(run, mesh=_jax_mesh22(),
                                       in_specs=(JP(runtime.SOLVE_AXES), JP(runtime.SOLVE_AXES)),
                                       out_specs=(JP(), JP()), check_vma=False))(
        x["sw_keys"].astype(np.uint32), x["sw_guesses"])
    for out in ranks:
        np.testing.assert_allclose(out["ms_two_tier_pose"], np.asarray(pose), atol=1e-5)
        np.testing.assert_allclose(out["ms_two_tier_cost"], float(cost), rtol=1e-5)


def test_rollout_merge_across_ranks_matches_full_k(x, ranks):
    """multi_swarm_rollout with axis_name: each rank's swarms through K2's
    plain version, the exact winners gathered: the full-K call, bit for
    bit, on every rank."""
    snap = tmap.MapSnapshot(**{k: torch.from_numpy(v) for k, v in x["snap"].items()})
    ref = multi_swarm.multi_swarm_rollout(
        torch.from_numpy(x["sw_keys"]), torch.from_numpy(x["sw_guesses"]), W.DEV, snap,
        torch.from_numpy(x["pts"]), torch.ones(200, dtype=torch.bool), W.PSO_CFG, W.MAP_CFG)
    for out in ranks:
        np.testing.assert_array_equal(out["msr_pose"], ref.pose.numpy())
        np.testing.assert_array_equal(out["msr_cost"], ref.cost.numpy())


@needs_jax
def test_tie_order_matches_jax(ranks):
    """Ranks 1 and 2 hold equal minimal costs and different poses: the
    merge picks as JAX's _global_merge does on the 2 x 2 virtual mesh, for
    each order of the axes (chips-major over ('chips', 'hosts'): rank 2)."""
    costs = jnp.asarray(W.TIE_COSTS, jnp.float32)
    poses = jnp.asarray([[float(r), 10.0 + r, 0.5] for r in range(RANKS)], jnp.float32)
    orders = (("chips", "hosts"), ("hosts", "chips"), ("chips",), ("hosts",))

    def run(c, p):
        return tuple(jms._global_merge(p, c, axes)[0][None] for axes in orders)

    out = jax.jit(jax.shard_map(run, mesh=_jax_mesh22(),
                                in_specs=(JP(runtime.SOLVE_AXES), JP(runtime.SOLVE_AXES)),
                                out_specs=JP(runtime.SOLVE_AXES), check_vma=False))(costs, poses)
    for r, rank in enumerate(ranks):
        for axes, want in zip(orders, out):
            np.testing.assert_array_equal(rank["tie_" + "_".join(axes)], np.asarray(want)[r],
                                          err_msg=f"rank {r} {axes}")
    assert ranks[0]["tie_chips_hosts"][0] == 2.0 and ranks[0]["tie_hosts_chips"][0] == 1.0


def _serial_merge(x):
    """One process ingesting every point of each merge scan: the state
    before the last build and the final map, numpy."""
    state, last = W.map_state(x, "cpu"), None
    for s in range(W.MERGE_SCANS):
        tmap.update(state, W.MAP_CFG, torch.from_numpy(x["merge_poses"][s]),
                    torch.from_numpy(x["merge_pts"][s]), torch.ones(160, dtype=torch.bool))
        if s == W.MERGE_SCANS - 1:
            last = {f: getattr(state, f).numpy().copy() for f in distributed.MERGED_FIELDS}
        tmap.build(state, W.MAP_CFG)
    return last, {f: getattr(state, f).numpy() for f in x["map"]}


def test_map_merge_matches_serial_ingestion(x, ranks):
    last, final = _serial_merge(x)
    for out in ranks:
        _check_merged({f: out[f"merged_{f}"] for f in distributed.MERGED_FIELDS}, last)
        _check_merged({f: out[f"map_{f}"] for f in x["map"]}, final)


def test_map_merge_same_bits_on_every_rank(x, ranks):
    for f in list(x["map"]) + [f"merged_{f}" for f in distributed.MERGED_FIELDS]:
        key = f if f.startswith("merged_") else f"map_{f}"
        for r in range(1, RANKS):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r} {key}")


@needs_jax
def test_map_merge_matches_jax_update(x, ranks):
    last, final = _jax_serial_merge(x)
    _check_merged({f: ranks[0][f"merged_{f}"] for f in distributed.MERGED_FIELDS},
                  {f: np.asarray(getattr(last, f)) for f in distributed.MERGED_FIELDS})
    _check_merged({f: ranks[0][f"map_{f}"] for f in x["map"]},
                  {f: np.asarray(getattr(final, f)) for f in x["map"]})


def _port_fleet(x, device="cpu"):
    cfg = W.fleet_cfg()
    states = tslam.init_slam_batch(cfg, x["fleet_init"], device)
    scans = tscan.Scan(points=torch.from_numpy(x["fleet_points"]).to(device),
                       valid=torch.from_numpy(x["fleet_valid"]).to(device))
    return fleet.run_offline_fleet(states, scans, x["fleet_keys"], cfg)


def test_fleet_sharded_matches_unsharded(x, ranks):
    """One robot per rank against the whole fleet in one process: poses,
    costs and each rank's maps bit for bit (tests/test_parallel.py:386-408)."""
    states, poses, costs = _port_fleet(x)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["fleet_poses"], poses.numpy())
        np.testing.assert_array_equal(out["fleet_costs"], costs.numpy())
        np.testing.assert_array_equal(out["fleet_mean_c"],
                                      states.map.mean_c.numpy()[_rows(r, W.FLEET_ROBOTS)])


@needs_jax
def test_fleet_sharded_matches_jax_fleet(x, ranks):
    """The JAX run_offline_fleet on the same scan points: poses within
    TRAJ_ATOL."""
    cfg = jcfg.SlamConfig(
        pso=jcfg.PSOConfig(iterations=15, population=50),
        map=jcfg.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4, slot_capacity=20),
        scan=jcfg.ScanConfig(max_beams=256), og=jcfg.OccupancyGridConfig(enabled=False),
        cost_mode="local_exact")
    states = jslam.init_slam_batch(cfg, x["fleet_init"])
    scans = jscan.Scan(points=jnp.asarray(x["fleet_points"]), valid=jnp.asarray(x["fleet_valid"]))
    _, poses, _ = jfleet.run_offline_fleet(states, scans, x["fleet_keys"].astype(np.uint32), cfg)
    np.testing.assert_allclose(ranks[0]["fleet_poses"], np.asarray(poses), atol=TRAJ_ATOL)


# -------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu)")
    return torch.device("cuda")


def _check_card_world(x, outs, device):
    """A world's results on the card against the unsharded calls in this
    process on the same card (deterministic algorithms for the fleet's
    scatter-adds): the solves and the fleet where the kernels ran at equal
    cluster size (B <= 15 rows: C = 8 both ways), the merge contract."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        n = len(outs)
        for mode in W.MODES:
            ref = tmesh.solve_batch(*W.solve_args(x, device), W.MAP_CFG, W.PSO_CFG, mode)
            for r, out in enumerate(outs):
                np.testing.assert_array_equal(out[f"dp_{mode}_pose"], ref.pose.cpu().numpy()[_rows(r, ranks=n)])
                launched = dict(zip(("rollout", "rollout_local", "score", "row_scatter"),
                                    out[f"dp_{mode}_launches"]))
                want = {"rollout_local": {"rollout_local": 1}, "rollout": {"rollout": 1},
                        "fast_fused": {"score": W.PSO_CFG.iterations + 2}}.get(mode, {})
                assert launched == {k: want.get(k, 0) for k in launched}, (mode, launched)
        _, poses, _ = _port_fleet(x, device)
        last, _ = _serial_merge(x)
    finally:
        torch.use_deterministic_algorithms(False)
    for out in outs:
        np.testing.assert_array_equal(out["fleet_poses"], poses.cpu().numpy())
        _check_merged({f: out[f"merged_{f}"] for f in distributed.MERGED_FIELDS}, last)


@pytest.mark.gpu
def test_two_ranks_on_one_card_over_gloo(x, cuda_device, tmp_path):
    outs = _run_world(str(tmp_path), "cuda", 2, 1, "gloo")
    for out in outs:
        assert str(out["device"]) == "cuda:0" and str(out["backend"]) == "gloo"
        routes = {" ".join(line.split()[:3]) for line in out["routes"]}
        assert routes == {"all_gather gloo cuda", "all_reduce gloo cuda"}, routes
    _check_card_world(x, outs, cuda_device)


@pytest.mark.gpu
def test_one_rank_over_nccl(x, cuda_device, tmp_path):
    (out,) = _run_world(str(tmp_path), "cuda", 1, 1)
    assert str(out["backend"]) == "nccl"
    routes = {" ".join(line.split()[:3]) for line in out["routes"]}
    assert routes == {"all_gather nccl cuda", "all_reduce nccl cuda"}, routes
    _check_card_world(x, [out], cuda_device)
