"""One rank of the port's multi-process test (torch only, no JAX).

    NDTPSO_COORDINATOR=localhost:PORT NDTPSO_NUM_PROCESSES=D NDTPSO_PROCESS_ID=r \
        python tests/torch_distributed_worker.py OUT_DIR DEVICE HOSTS CHIPS [BACKEND]

Joins a world of HOSTS x CHIPS ranks (``parallel/runtime.py``), builds the
same seeded inputs as every other rank (:func:`inputs`, on the CPU, then on
DEVICE), and runs on its rows: the dp solves over the hierarchy
(``make_hier_solver``, several cost modes, and the flat ``solve_batch_sharded``
on one shared map), the two-tier multi-swarm exchange, ``multi_swarm_rollout``
across ranks, the merge's tie order, the exact map merge and the sharded
fleet.  Writes ``OUT_DIR/rank{r}.npz``; tests/test_torch_distributed.py holds
what the ranks wrote to the port's unsharded calls and to the JAX package.
"""

import os
import sys
import time

import numpy as np
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.io import synthetic
from ndtpso_slam_tpu_torch.models import cost as tcost
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.models import slam as tslam
from ndtpso_slam_tpu_torch.ops import rollout as tro
from ndtpso_slam_tpu_torch.ops import rollout_local as trl
from ndtpso_slam_tpu_torch.ops import row_scatter as trs
from ndtpso_slam_tpu_torch.ops import score as tsc
from ndtpso_slam_tpu_torch.parallel import distributed, fleet, multi_swarm, runtime
from ndtpso_slam_tpu_torch.parallel import mesh as tmesh

MAP_CFG = tcfg.MapConfig(size_m=32.0, cell_side_m=1.0, window_slots=4)
PSO_CFG = tcfg.PSOConfig(iterations=8, population=64)
DEV = np.float32([0.2, 0.2, 0.05])
N_PAD = 256
B = 8  # solves, swarms and (halved) robots: divisible by 4 and by 2 ranks
MODES = ("fast", "rollout_local", "rollout", "fast_fused")
EXCHANGE = (2, 4)  # exchange_every, dcn_exchange_every (__graft_entry__.py:163-171)
MERGE_SCANS = 3
FLEET_ROBOTS = 4
FLEET_SCANS = 5
# The tie case: the ranks' incumbent costs.  Ranks 1 and 2 tie at the
# minimum; hosts-major order meets rank 1 first, chips-major rank 2.
TIE_COSTS = (0.0, -1.0, -1.0, 0.0)


def fleet_cfg():
    """tests/test_torch_fleet.py's fleet configuration."""
    return tcfg.SlamConfig(
        pso=tcfg.PSOConfig(iterations=15, population=50),
        map=tcfg.MapConfig(size_m=48.0, cell_side_m=1.0, window_slots=4, slot_capacity=20),
        scan=tcfg.ScanConfig(max_beams=256), og=tcfg.OccupancyGridConfig(enabled=False),
        cost_mode="local_exact")


def inputs():
    """Every seeded input, numpy, the same in each rank and in the test:
    tests/test_parallel.py's ellipse world (its map built by the port on the
    CPU), B solves of its points, K=B swarms, the points of MERGE_SCANS
    scans, and the fleet's scans."""
    rs = np.random.RandomState(0)
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    pts = (np.stack([9 * np.cos(t), 6 * np.sin(t)], -1) + rs.normal(0, 0.05, (200, 2))).astype(np.float32)
    state = tmap.init_map(MAP_CFG, device="cpu")
    for _ in range(2):
        noisy = pts + rs.normal(0, 0.02, pts.shape).astype(np.float32)
        tmap.add_points(state, MAP_CFG, torch.from_numpy(noisy), torch.ones(200, dtype=torch.bool))
        tmap.build(state, MAP_CFG)
    snap = tmap.snapshot(state, MAP_CFG)
    rs2 = np.random.RandomState(1)
    merge_pts = np.stack([
        np.stack([7 * np.cos(t[:160]) + 0.3 * s, 5 * np.sin(t[:160]) - 0.2 * s], -1)
        + rs.normal(0, 0.03, (160, 2)) for s in range(MERGE_SCANS)]).astype(np.float32)
    logs = [synthetic.make_log(seed=20 + r, n_scans=FLEET_SCANS, n_beams=256, world_size=40.0,
                               odom_noise=0.02) for r in range(FLEET_ROBOTS)]
    cfg = fleet_cfg()
    loaded = [[tscan.load_laser(x, lg.angle_min, lg.angle_increment, lg.range_max, cfg.scan,
                                cfg.map, device="cpu") for x in lg.ranges] for lg in logs]
    return dict(
        snap={k: getattr(snap, k).numpy() for k in ("mean", "inv_cov", "built")},
        map={f: getattr(state, f).numpy() for f in ("mean_c", "inv_cov", "built", "created",
                                                    "g_sum", "g_count", "g_cov", "slot_sum",
                                                    "slot_count", "slot_cov", "slot_idx",
                                                    "rot_count", "cur_sum", "cur_count",
                                                    "cur_m2")},
        pts=pts,
        keys=rs2.randint(0, 2**31, (B, 2)).astype(np.int64),
        guesses=np.zeros((B, 3), np.float32),
        sw_keys=rs2.randint(0, 2**31, (B, 2)).astype(np.int64),
        sw_guesses=rs2.uniform(-0.3, 0.3, (B, 3)).astype(np.float32),
        merge_pts=merge_pts,
        merge_poses=np.float32([[0.0, 0.0, 0.0], [0.1, -0.05, 0.01], [-0.1, 0.05, -0.02]]),
        fleet_points=np.stack([[s.points.numpy() for s in row] for row in loaded]),
        fleet_valid=np.stack([[s.valid.numpy() for s in row] for row in loaded]),
        fleet_init=np.stack([lg.poses[0] for lg in logs]).astype(np.float32),
        fleet_keys=np.stack([np.full(FLEET_ROBOTS, 3), np.arange(9, 9 + FLEET_ROBOTS)], -1),
    )


def padded(x):
    """The world's 200 points padded to N_PAD (the JAX rollout kernels take
    a lane-aligned N), and their mask."""
    points = np.zeros((N_PAD, 2), np.float32)
    points[:200] = x["pts"]
    return points, np.arange(N_PAD) < 200


def solve_args(x, device):
    """The B solves' (keys, guesses, deviations, stacked snaps, points [B,
    N_PAD, 2], valid) on ``device``."""
    on = lambda a: torch.from_numpy(a).to(device)
    snap = {k: np.broadcast_to(v, (B,) + v.shape) for k, v in x["snap"].items()}
    points, valid = padded(x)
    return (on(x["keys"]), on(x["guesses"]), on(np.tile(DEV, (B, 1))),
            tmap.MapSnapshot(**{k: on(np.ascontiguousarray(v)) for k, v in snap.items()}),
            on(np.tile(points[None], (B, 1, 1))), on(np.tile(valid[None], (B, 1))))


def exact_cost(x, device):
    snap = tmap.MapSnapshot(**{k: torch.from_numpy(v).to(device) for k, v in x["snap"].items()})
    pts = torch.from_numpy(x["pts"]).to(device)
    valid = torch.ones(200, dtype=torch.bool, device=device)
    return lambda poses, binds: tcost.ndt_cost(poses, snap, pts, valid, MAP_CFG)


def map_state(x, device):
    state = tmap.init_map(MAP_CFG, device=device)
    for f, v in x["map"].items():
        getattr(state, f).copy_(torch.from_numpy(v))
    return state


def launches():
    return {"rollout": tro.pso_rollout.LAUNCHES, "rollout_local": trl.pso_rollout_local.LAUNCHES,
            "score": tsc.fused_bound_scores.LAUNCHES, "row_scatter": trs.row_scatter.LAUNCHES}


def run(out_dir, device, hosts, chips, backend=None):
    torch.set_num_threads(1)
    assert runtime.initialize_distributed(backend=backend, device=device), "NDTPSO_* must be set"
    mesh = runtime.make_hier_mesh(hosts, chips, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        # The fleet's map scatter-adds sum in the unsharded run's order.
        torch.use_deterministic_algorithms(True, warn_only=True)
    x = inputs()
    out = {"device": str(dev), "backend": torch.distributed.get_backend()}
    t0 = time.perf_counter()

    # 1. dp solves over the whole hierarchy, and the flat one-shot on one
    #    shared snapshot.
    args = runtime.shard_global(mesh, runtime.SOLVE_AXES,
                                runtime.shard_rows(mesh, solve_args(x, "cpu")))
    for mode in MODES:
        before = launches()
        res = runtime.make_hier_solver(mesh, MAP_CFG, PSO_CFG, mode)(*args)
        out[f"dp_{mode}_launches"] = np.array([launches()[k] - before[k] for k in before])
        out[f"dp_{mode}_pose"], out[f"dp_{mode}_cost"] = res.pose.cpu().numpy(), res.cost.cpu().numpy()
        full = runtime.gather_global(mesh, tuple(res))
        out[f"dp_{mode}_gathered"] = full[0].cpu().numpy()
    flat = tmesh.make_mesh(device=device)
    keys, guesses, devs, _, points, valid = runtime.shard_rows(flat, solve_args(x, dev))
    snap = runtime.replicate_global(flat, tmap.MapSnapshot(**x["snap"]))
    res = tmesh.solve_batch_sharded(flat, keys, guesses, devs, snap, points, valid, MAP_CFG,
                                    PSO_CFG, "fast", shared_map=True)
    out["shared_pose"], out["shared_cost"] = res.pose.cpu().numpy(), res.cost.cpu().numpy()

    # 2. the multi-swarm exchange: two-tier, and every merge across hosts.
    sw_keys, sw_guesses = runtime.shard_global(
        mesh, runtime.SOLVE_AXES, runtime.shard_rows(mesh, (x["sw_keys"], x["sw_guesses"])))
    for name, (every, dcn_every) in (("two_tier", EXCHANGE), ("global", (2, 2))):
        res = multi_swarm.multi_swarm_solve(
            sw_keys, sw_guesses, DEV, exact_cost(x, dev), PSO_CFG, exchange_every=every,
            axis_name=runtime.ICI_AXIS, dcn_axis_name=runtime.DCN_AXIS,
            dcn_exchange_every=dcn_every, mesh=mesh)
        out[f"ms_{name}_pose"], out[f"ms_{name}_cost"] = res.pose.cpu().numpy(), res.cost.cpu().numpy()
    snap = runtime.replicate_global(mesh, tmap.MapSnapshot(**x["snap"]))
    pts = torch.from_numpy(x["pts"]).to(dev)
    res = multi_swarm.multi_swarm_rollout(
        sw_keys, sw_guesses, DEV, snap, pts, torch.ones(200, dtype=torch.bool, device=dev),
        PSO_CFG, MAP_CFG, axis_name=runtime.SOLVE_AXES, mesh=mesh)
    out["msr_pose"], out["msr_cost"] = res.pose.cpu().numpy(), res.cost.cpu().numpy()

    # 3. the merge's tie order: equal minima on two ranks, different poses.
    cost = torch.tensor([TIE_COSTS[mesh.rank % len(TIE_COSTS)]], device=dev)
    pose = torch.tensor([[float(mesh.rank), 10.0 + mesh.rank, 0.5]], device=dev)
    for axes in (("chips", "hosts"), ("hosts", "chips"), ("chips",), ("hosts",)):
        got, _ = multi_swarm._global_merge(pose, cost, mesh, axes)
        out["tie_" + "_".join(axes)] = got.cpu().numpy()

    # 4. the exact map merge: each rank ingests its share of each scan.
    state = map_state(x, dev)
    for s in range(MERGE_SCANS):
        p, v = runtime.shard_rows(mesh, (torch.from_numpy(x["merge_pts"][s]).to(dev),
                                         torch.ones(160, dtype=torch.bool, device=dev)))
        distributed.sharded_update(state, MAP_CFG, torch.from_numpy(x["merge_poses"][s]).to(dev),
                                   p, v, mesh, runtime.SOLVE_AXES)
        if s == MERGE_SCANS - 1:
            # Copies: the build below updates the state in place.
            out.update({f"merged_{f}": getattr(state, f).cpu().numpy().copy()
                        for f in distributed.MERGED_FIELDS})
        tmap.build(state, MAP_CFG)
    out.update({f"map_{f}": getattr(state, f).cpu().numpy() for f in x["map"]})

    # 5. the sharded fleet: this rank's robots.
    cfg = fleet_cfg()
    robots = runtime.shard_rows(mesh, np.arange(FLEET_ROBOTS))
    states = tslam.init_slam_batch(cfg, x["fleet_init"][robots], dev)
    scans = tscan.Scan(points=torch.from_numpy(x["fleet_points"][robots]).to(dev),
                       valid=torch.from_numpy(x["fleet_valid"][robots]).to(dev))
    states, poses, costs = fleet.run_offline_fleet_sharded(
        mesh, states, scans, x["fleet_keys"][robots], cfg, axis=runtime.SOLVE_AXES)
    out["fleet_poses"], out["fleet_costs"] = poses.cpu().numpy(), costs.cpu().numpy()
    out["fleet_mean_c"] = states.map.mean_c.cpu().numpy()

    out["routes"] = np.array([f"{op} {backend} {route} {n}"
                              for (op, backend, route), n in sorted(mesh.routes.items())])
    out["wall_s"] = time.perf_counter() - t0
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"[rank {mesh.rank}] WORKER OK in {out['wall_s']:.2f} s", flush=True)


if __name__ == "__main__":
    out_dir, device, hosts, chips = sys.argv[1:5]
    run(out_dir, device, int(hosts), int(chips), sys.argv[5] if len(sys.argv) > 5 else None)
