"""Phase 5d's K2 global-route check (chip_smoke.py) over many maps built on
the card: how often K2 and its plain version part, and where.

    python k2_near_tie.py [MAPS]

For each of MAPS (default 16) batch worlds of chip_smoke.py (the 64 m map
built on the card with atomic scatter-adds, so its last bits change from
world to world), K2 and its plain version at 5d's shape (B=256, P=8192,
I=50, the cluster size K2's chooser picks) are held to each other with 5d's
tolerances.  For each solve where they part, one JSON line: chip_smoke.py's
``k2_tie`` (the first iteration whose global best differs, the particle each
side took there, their costs in K2's order, the plain version's and float64,
and whether it is a tie within the two sum orders' resolution).  Then, per
such map, whether K2 agrees with the plain version run taking K2's side of
the ties (``_take_k2_ties``), and one summary line with the card's name and
power limit.  Needs one GPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from ndtpso_slam_tpu_torch.ops import _build
    from ndtpso_slam_tpu_torch.ops import rollout as ro

    argv = sys.argv[1:] if argv is None else argv
    maps = int(argv[0]) if argv else 16
    if not torch.cuda.is_available():
        print("k2_near_tie: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(ro.LIB)
    tol = cs._TOLERANCES["rollout"]
    t0 = time.perf_counter()
    parted_maps, ties, held = 0, 0, 0
    for m in range(maps):
        world = cs.batch_world(cs.BATCH, torch.device("cuda"))
        world["pso_cfg"] = dataclasses.replace(world["pso_cfg"], population=8192)
        packed = cs._packed(world)
        got = ro.pso_rollout(*packed)
        torch.cuda.synchronize()
        cluster = ro.pso_rollout.LAST_CLUSTER or 1
        ref = ro.pso_rollout_reference(*packed, cluster=cluster)
        off = cs._parted(got, ref, tol)
        if not off:
            continue
        parted_maps += 1
        best = cs._k2_best_after(packed, cluster)
        for s in off:
            t = cs.k2_tie(packed, cluster, s, {}, best)
            ties += t["tie"]
            print(json.dumps(dict(map=m, cluster=cluster, **t)), flush=True)
        try:
            steered = cs._take_k2_ties("k2_near_tie", packed, cluster, got, ref, tol)
            held += not cs._parted(got, steered, tol)
        except RuntimeError as err:
            print(json.dumps(dict(map=m, error=str(err))), flush=True)
    print(json.dumps(dict(maps=maps, maps_parted=parted_maps, ties=ties,
                          maps_held_after_ties=held, seconds=round(time.perf_counter() - t0, 1),
                          card=cs._smi())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
