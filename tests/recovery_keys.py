"""How often a kidnap relocalization lands within the 0.3 m gate, key by
key, in the JAX package and in the port (CPU, plain PyTorch path).

    JAX_PLATFORMS=cpu python tests/recovery_keys.py [--bench-only | --wide]

Two workloads:

* tests/test_recovery.py's kidnap (48 m map, grid 24 x 24 x 16): per key,
  the JAX step on the scans it loads, the port on those same scan points,
  and the port on the scans it loads itself; recoveries and the xy error of
  the last two scans;
* bench.py's recovery workload (``--config recovery --full-scale``: 300 m
  frame, 0.5 m cells) reduced to 4 slots so it fits a CPU: per key, the JAX
  step (``local_exact``, as bench.py) and the port's (``rollout_local``, as
  chip_smoke.py phase 7c), their errors and exact costs against the truth's.

Prints one line per key.  Each JAX step compiles once (~1 min).
"""

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ndtpso_slam_tpu import config as jcfg  # noqa: E402
from ndtpso_slam_tpu.io import synthetic as jsynth  # noqa: E402
from ndtpso_slam_tpu.models import cost as jcost  # noqa: E402
from ndtpso_slam_tpu.models import ndt_map as jmap  # noqa: E402
from ndtpso_slam_tpu.models import scan as jscan  # noqa: E402
from ndtpso_slam_tpu.models import slam as jslam  # noqa: E402
from ndtpso_slam_tpu.ops import rng as jrng  # noqa: E402
from ndtpso_slam_tpu.ops.geometry import cell_index, transform_points  # noqa: E402
from ndtpso_slam_tpu_torch import config as tcfg  # noqa: E402
from ndtpso_slam_tpu_torch.models import cost as tcost  # noqa: E402
from ndtpso_slam_tpu_torch.models import ndt_map as tmap  # noqa: E402
from ndtpso_slam_tpu_torch.models import scan as tscan  # noqa: E402
from ndtpso_slam_tpu_torch.models import slam as tslam  # noqa: E402
from test_torch_recovery import N_BEAMS, _cfg, _load, _run, _xy_err, kidnap_workload  # noqa: E402

TEST_KEYS = [(21, 9), (1, 2), (3, 4), (7, 8)]
WIDE_KEYS = [(k, k + 1) for k in range(25, 125, 2)]
BENCH_KEYS = [(11, 13), (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (21, 9), (17, 18)]
BENCH_SLOTS = 4


def _jkey(key, i=None):
    k = (np.uint32(key[0]), np.uint32(key[1]))
    return k if i is None else jrng.threefry2x32(k, np.uint32(i), np.uint32(0))


def sweep_test_kidnap(keys=TEST_KEYS):
    poses, ranges = kidnap_workload()
    jc, tc = _cfg(jcfg, True), _cfg(tcfg, True)
    jscans = [jscan.load_laser(r, -np.pi, 2 * np.pi / N_BEAMS, 30.0, jc.scan, jc.map)
              for r in ranges]
    shared = [tscan.Scan(points=torch.from_numpy(np.array(s.points)),
                         valid=torch.from_numpy(np.array(s.valid))) for s in jscans]
    own = [_load(r, tc) for r in ranges]
    err = lambda est: np.round(_xy_err(est, poses)[-2:], 3).tolist()
    found = {"JAX": [], "port on JAX's scans": [], "port on its own scans": []}
    for key in keys:
        st, out = jslam.init_slam(jc, tuple(poses[0])), []
        for i, sc in enumerate(jscans):
            st, p, _ = jslam.slam_step(st, sc, _jkey(key, i), jc)
            out.append(np.asarray(p, np.float64))
        pj = np.stack(out)
        s1, p1 = _run(tc, poses[0], shared, key)
        s2, p2 = _run(tc, poses[0], own, key)
        print(f"test kidnap, key {key}: JAX recoveries {int(st.recoveries)} err {err(pj)} | "
              f"port on JAX's scans {s1.recoveries} {err(p1)} (max |dpose| "
              f"{np.abs(p1 - pj).max():.1e}) | port on its own scans {s2.recoveries} {err(p2)}",
              flush=True)
        for name, est in zip(found, (pj, p1, p2)):
            if max(err(est)) < 0.3:
                found[name].append(key)
    print(f"test kidnap, relocalized within 0.3 m on {len(keys)} keys: "
          + "; ".join(f"{name} {len(k)} {k}" for name, k in found.items()), flush=True)


def sweep_bench_recovery():
    mc = jcfg.MapConfig(size_m=300.0, cell_side_m=0.5, window_slots=BENCH_SLOTS)
    base = jcfg.SlamConfig(pso=jcfg.PSOConfig(iterations=30, population=50), map=mc,
                           scan=jcfg.ScanConfig(max_beams=384), cost_mode="local_exact")
    cfg = dataclasses.replace(base, recovery=jcfg.RecoveryConfig(enabled=True))
    lg = jsynth.make_log(seed=3, n_scans=31, n_beams=360, world_size=50.0)
    loaded = [jscan.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max, base.scan, mc)
              for r in lg.ranges]
    st = jslam.init_slam(cfg, initial_pose=tuple(lg.poses[0]))
    m, prev_ids = st.map, jnp.full((384,), mc.num_cells, jnp.int32)
    for s, pose in zip(loaded[:30], lg.poses[:30]):  # bench.py:662-676
        wpts = transform_points(s.points, jnp.asarray(pose, jnp.float32))
        idx, inb = cell_index(wpts, size_m=mc.size_m, cell_side_m=mc.cell_side_m,
                              cells_per_side=mc.cells_per_side)
        ids = jnp.where(s.valid & inb, idx, mc.num_cells)
        m = jmap.add_points(m, mc, wpts, s.valid)
        m = jmap.build_touched(m, mc, jnp.concatenate([ids, prev_ids]))
        prev_ids = ids
    prev = jnp.asarray(lg.poses[29], jnp.float32)
    st = st.replace(map=m, prev_ids=prev_ids, pose=prev, step=jnp.asarray(30, jnp.int32),
                    align=jslam.AlignState(prev_pose=prev, iter=jnp.asarray(30, jnp.int32),
                                           pose_diff=jnp.asarray(lg.poses[29] - lg.poses[28],
                                                                 jnp.float32)))
    tc, tst, _, tkid, kid_pose = chip_smoke.reloc_launch_world(torch.device("cpu"), BENCH_SLOTS)
    kid_r = jsynth.raycast(jsynth.make_world(seed=3, size=50.0), kid_pose, 360, lg.angle_min,
                           lg.angle_increment, lg.range_max)
    kid = jscan.load_laser(kid_r.astype(np.float32), lg.angle_min, lg.angle_increment,
                           lg.range_max, base.scan, mc)
    snap = jmap.snapshot(st.map, mc)
    jexact = lambda p: float(jcost.ndt_cost(jnp.asarray(p, jnp.float32), snap, kid.points,
                                            kid.valid, mc))
    tsnap = tmap.snapshot(tst.map, tc.map)
    texact = lambda p: float(tcost.ndt_cost(torch.as_tensor(p, dtype=torch.float32), tsnap,
                                            tkid.points, tkid.valid, tc.map))

    def err(p):
        e = np.abs(np.asarray(p, np.float64) - kid_pose)
        e[2] = abs((e[2] + np.pi) % (2 * np.pi) - np.pi)
        return e.round(4).tolist()

    print(f"bench recovery ({BENCH_SLOTS} slots): exact cost at the truth JAX "
          f"{jexact(kid_pose):.3f}, port {texact(kid_pose):.3f}", flush=True)
    for key in BENCH_KEYS:
        jst, jp, _ = jslam.slam_step(st, kid, _jkey(key), cfg)
        new, tp, _ = tslam.slam_step(chip_smoke._fresh(tst), tkid, key, tc)
        print(f"bench recovery, key {key}: JAX recoveries {int(jst.recoveries)} err {err(jp)} exact "
              f"{jexact(jp):.3f} | port recoveries {new.recoveries} err {err(tp.numpy())} exact "
              f"{texact(tp):.3f}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    if "--wide" in sys.argv:
        sweep_test_kidnap(TEST_KEYS + WIDE_KEYS)
    else:
        if "--bench-only" not in sys.argv:
            sweep_test_kidnap()
        sweep_bench_recovery()
