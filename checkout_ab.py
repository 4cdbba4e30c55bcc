"""Times the whole-solve kernels K1 and K2, the scoring kernel K3, E7's
stages 1-3, the scan.launch step, K1's host time, the row scatter E4, the
probes E5 and E6 and the scoring studies E1-E3 of one or more checkouts of
this repository, on one GPU.

    python checkout_ab.py ROOT [ROOT ...] [--clusters] [--probes] [--studies] [--step]

Each ROOT is a checkout (its package and its chip_smoke.py).  Each runs in a
process of its own that imports only from its ROOT, in the order given, so an
A/B of two checkouts on one card names them in turns: A B B A.  The
workloads are chip_smoke.py's own, built by the checkout's chip_smoke.py:
phase 4's 50-scan scan.launch log (step latency, over STEP_RUNS runs of the
log, each on a new node; then K1 at B=1 on the next solve's inputs: its
CUDA-event time, the host time of one wrapper call until it returns, and
the wall time of a call and a synchronize; then phase 4's profiled window,
device kernels per scan), phase 5's
batch world (K2 f32 and turbo with early exit 2 at B=256, K3 on one cost
evaluation of its 256 solves; K2 f32 and bf16 and K1 turbo on its first 16
solves, at the cluster size the checkout's chooser picks)
and E7's binding inputs at K2's shape
(stages 1-3); E4 on phase 6d's inputs (the fleet's 12,288 update rows at
W=2 with one and three fields, and at W=128): CUDA events back to back,
device busy per call (torch.profiler, chip_smoke.py's ``_profile``) and
the host time of one call until it returns, beside ``index_copy_``'s; the
four E5 probes on phase 6e's inputs at C1's batch shape (B=256, N=384)
and ``torch.sum`` over the same points: CUDA events one cold-L2 call at a
time (mean and median; the L2 evicted by a read of chip_smoke.py's
``FLUSH_BYTES``), device busy and device operations per call, host time; the seven E6 probes on phase 6f's seeded [8, 512] tile,
device busy and operations per call, host time and a CUDA graph's time per
call (``_graph_us``), beside ``x + C``, ``torch.sum``'s row sums broadcast
and ``einsum``'s column totals, read the same four ways.  Kernel times are CUDA
events (chip_smoke.py's
``_events_ms``); host times are medians of ``time.perf_counter``.  K3's
SASS (``cuobjdump -sass`` of the checkout's built library) gives the
instructions its score loop runs per (particle, point) pair: the
innermost loop holding MUFU.EX2, whose count is the pairs per trip.  Prints
one JSON line per ROOT, with the card's name and power limit.
``--clusters`` adds, for checkouts whose wrappers take ``cluster=``, K1
turbo and K2 bf16 at B=16 on every cluster size that fits; ``--probes``
measures E5 and E6 alone; ``--step`` stops after phase 4's numbers (step
latency, K1 at B=1, device kernels per scan).

``--studies`` measures the kernels of ``csrc/score_variants.cu`` alone, at
chip_smoke.py's phase 6a-6c shapes: E1's six configurations (B=64, N=384,
P=4096), E2's nine (the population call's operands of phase 6c, B=32,
padded to 16 features) and E3's five variants (B=64, I=50), each as CUDA
events back to back (E1 and E2 over 20 calls, E3 over 3) and device busy
and device operations per call (torch.profiler over PROFILE_CALLS calls, 5
for E3), E1's and E2's host time per call until it returns, and E3's
launch geometry where the checkout's wrapper records it
(``score_block.LAST``: cluster size, CTAs); the ptxas lines of the
library's instantiations (registers, stack, spills; its build log) and
each instantiation's SASS loop mix; and, as the controls that must not
move, K2 f32 at B=256 and at B=16, K1 turbo at B=16, K3 at B=256 (and its
SASS loop) and E7's stage 3 at K2's shape (CUDA events).  ~60 s per
checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

CLUSTERS = (1, 2, 4, 8)
HOST_REPS = 300
STEP_RUNS = 5
PROFILE_CALLS = 20
COLD_REPS = 20
GRAPH_REPLAYS = 10
GRAPH_SEGMENTS = 7


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _loop_mix(sass: str) -> dict:
    """Opcode counts per exp of the loop (backward branch) with the most
    MUFU.EX2 in one function's SASS: per (particle, point) pair in a
    scoring loop that takes one exp per pair."""
    import collections

    code = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", sass)]
    best = None
    for addr, op, rest in code:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if target is None or int(target.group(1), 16) >= addr:
            continue
        body = [o for a, o, _ in code if int(target.group(1), 16) <= a <= addr]
        exps = sum(o.startswith("MUFU.EX2") for o in body)
        if exps and (best is None or exps > best[0] or (exps == best[0] and len(body) < len(best[1]))):
            best = (exps, body)
    if best is None:
        return {}
    exps, body = best
    mix = collections.Counter(o.split(".")[0] for o in body)
    return dict(per_pair=len(body) / exps, pairs_per_trip=exps,
                mix={k: round(v / exps, 3) for k, v in mix.most_common()})


def _sass_mixes(lib, _build, kernel) -> dict:
    """The score-loop mix of each instantiation of ``kernel`` (a substring
    of its name) in a built library, by its name from ``kernel`` on."""
    out = subprocess.run([os.path.join(os.path.dirname(_build._compiler("nvcc")), "cuobjdump"), "-sass",
                          str(lib.path())], capture_output=True, text=True, check=True).stdout
    mixes = {}
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if kernel in name:
            mixes[re.sub(r".*" + kernel, kernel, name)] = _loop_mix(fn)
    return mixes


def _k3_sass(sc, _build) -> dict:
    """K3's score-loop mix per instantiation, from its built library."""
    return _sass_mixes(sc.LIB, _build, "score_kernel")


def _k1_next_solve(cs, node, lg):
    """K1's arguments for the solve the main path would run next (as
    chip_smoke.py's phase_main_kernel builds them)."""
    import torch

    from ndtpso_slam_tpu_torch.models import ndt_map
    from ndtpso_slam_tpu_torch.models import scan as scan_mod
    from ndtpso_slam_tpu_torch.ops import rng

    cfg, st = node.slam_cfg, node.state
    scan = scan_mod.load_laser(lg.ranges[-1], lg.angle_min, lg.angle_increment,
                               lg.range_max, cfg.scan, cfg.map)
    snap = ndt_map.snapshot(st.map, cfg.map)
    guess = st.pose[None]
    devs = torch.abs(st.align.pose_diff * cfg.deviation_scale)[None]
    sten, pts = cs._pack(snap, cfg.map, guess, scan.points, scan.valid)
    keys = torch.tensor([rng.derive_key(node._key, st.step)], dtype=torch.int64,
                        device=guess.device)
    return (keys, guess, devs, sten, pts, cfg.pso, cfg.map)


def _host_us(fn):
    """Medians over HOST_REPS calls, in µs: until fn returns, and until the
    card has finished it.  The card is idle before each call."""
    import torch

    ret, done = [], []
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        ret.append(t1 - t0)
        done.append(time.perf_counter() - t0)
    med = lambda xs: sorted(xs)[len(xs) // 2] * 1e6
    return med(ret), med(done)


def _cluster_times(cs, rl, ro, small, out):
    """K1 turbo and K2 bf16 on small's solves at every cluster size that fits
    a CTA's shared memory."""
    import torch

    from ndtpso_slam_tpu_torch.ops import _build

    pl, pf = cs._packed(small, local=True), cs._packed(small)
    n, p = pf[4].shape[-1], small["pso_cfg"].population
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for c in CLUSTERS:
        for name, fn, smem in (
            ("k1_turbo_b16", lambda: rl.pso_rollout_local(*pl, rng_mode="native", cluster=c),
             rl.smem_bytes(n, p, c)),
            ("k2_bf16_b16", lambda: ro.pso_rollout(*pf, score_dtype="bf16", cluster=c),
             ro.smem_bytes(n, p, c)),
        ):
            fits = smem + _build.STATIC_SMEM <= limit
            out[f"{name}_c{c}_ms"] = cs._events_ms(fn, 3) if fits else None


def _device_us(cs, fn):
    """Device busy per call (µs) over PROFILE_CALLS calls back to back."""
    fn()
    return cs._profile(lambda: [fn() for _ in range(PROFILE_CALLS)])[1] / PROFILE_CALLS * 1e3


def _e4(cs, dev, out):
    """E4 (row_scatter beside index_copy_)."""
    import numpy as np
    import torch

    from ndtpso_slam_tpu_torch.experiments import scatter_unique_ab as su
    from ndtpso_slam_tpu_torch.ops import row_scatter as rsc

    ids, rs = su.fleet_ids()
    fid = torch.from_numpy(ids).to(dev)
    for key, rows, idx, width, n_fields in (("w2", su.R, fid, su.W, 1), ("w2x3", su.R, fid, su.W, 3),
                                            ("w128", su.C, fid % su.C, su.W_TPU, 1)):
        vals = [torch.from_numpy(rs.randn(su.M, width).astype(np.float32)).to(dev)
                for _ in range(n_fields)]
        ops = [torch.zeros((rows + 1, width), device=dev) for _ in range(n_fields)]
        for name, fn in (("e4", lambda: rsc.row_scatter(ops, idx, vals)),
                         ("index_copy", lambda: [op.index_copy_(0, idx, v)
                                                 for op, v in zip(ops, vals)])):
            out[f"{name}_{key}_ms"] = cs._events_ms(fn, 30)
            out[f"{name}_{key}_device_us"] = _device_us(cs, fn)
            out[f"{name}_{key}_host_us"] = _host_us(fn)[0]


def _cold_ms(fn, flush):
    """CUDA events around each of COLD_REPS calls of fn, each after a read
    of ``flush`` that evicts the L2 and hides the host's enqueue time (both
    warmed first): (mean, median) ms per call.  The same code times every
    checkout."""
    import torch

    flush.sum()
    fn()
    pairs = []
    for _ in range(COLD_REPS):
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in pairs)
    return sum(ms) / len(ms), ms[len(ms) // 2]


def _split(cs, key, fn, out, flush=None):
    """fn's device busy and device operations per call over PROFILE_CALLS
    calls back to back, and its host time until it returns; with a
    ``flush`` buffer, also its CUDA-event time one call at a time with a
    cold L2 (mean and median)."""
    fn()
    if flush is not None:
        out[f"{key}_cold_ms"], out[f"{key}_cold_median_ms"] = _cold_ms(fn, flush)
    ops, busy, _ = cs._profile(lambda: [fn() for _ in range(PROFILE_CALLS)])
    out[f"{key}_device_us"] = busy / PROFILE_CALLS * 1e3
    out[f"{key}_device_ops"] = ops / PROFILE_CALLS
    out[f"{key}_host_us"] = _host_us(fn)[0]


def _graph_us(fn, calls=PROFILE_CALLS):
    """µs per call of fn: one CUDA graph that holds ``calls`` calls back to
    back, warmed, then timed in GRAPH_SEGMENTS segments of GRAPH_REPLAYS
    replays between CUDA events; the median segment over its calls
    (chip_smoke.py's ``_graph_ms``, kept here so that the same code times
    every checkout).  No profiler record is involved, so a dropped one
    cannot change it."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    pairs = []
    for _ in range(GRAPH_SEGMENTS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs) / (GRAPH_REPLAYS * calls) * 1e3


def _e5_e6(cs, dev, out):
    """The E5 probes at C1's batch shape beside torch.sum over the points,
    and the E6 probes on the seeded tile beside their library calls: x + C
    (col3), torch.sum's broadcast row sums (bcast_out) and einsum's column
    totals (dotgen), each E6 reading also as a CUDA graph's time per call."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import io_probe as iop
    from ndtpso_slam_tpu_torch.experiments import mosaic_probe as mp
    from ndtpso_slam_tpu_torch.ops import probes

    b, n = cs.IO_WIDE
    inp = iop.inputs(dev, b, n)
    flush = torch.zeros(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for name in probes.IO_PROBES:
        args = iop.probe_args(name, inp)
        _split(cs, f"e5_{name}", lambda: probes.io_probe(name, *args), out, flush)
    table = inp["pts"].view(b, 1, 8, n)
    _split(cs, "e5_torch_sum", lambda: torch.sum(table, dim=(1, 3)), out, flush)
    del inp, table, flush
    x, xi = mp.inputs(dev, seed=5)
    c = torch.tensor([1.0, 2.0] + [3.0] * (probes.ROWS - 2), device=dev)[:, None]
    head = x[:, :mp.N]
    e6 = {f"e6_{name}": (lambda name=name: probes.mosaic_probe(
        name, xi if name == "threefry" else x, mp.N)) for name in probes.MOSAIC_PROBES}
    e6.update(e6_x_plus_c=lambda: x + c,
              e6_torch_sum=lambda: torch.sum(x, dim=1, keepdim=True).expand_as(x),
              e6_einsum=lambda: torch.einsum("rn,rq->q", head, x))
    for key, fn in e6.items():
        _split(cs, key, fn, out)
        out[f"{key}_graph_us"] = _graph_us(fn)


def _study_split(cs, key, fn, reps, calls, out):
    """fn's CUDA-event time over reps calls back to back, and its device
    busy and device operations per call over ``calls`` calls."""
    out[f"{key}_ms"] = cs._events_ms(fn, reps)
    ops, busy, _ = cs._profile(lambda: [fn() for _ in range(calls)])
    out[f"{key}_device_ms"] = busy / calls
    out[f"{key}_device_ops"] = ops / calls


def _e2_operands(dev):
    """Phase 6c's population call: binds at the guesses and phi of the
    initial poses, padded to 16 features, and its mask."""
    import torch

    from ndtpso_slam_tpu_torch.experiments import pallas_variants as pv
    from ndtpso_slam_tpu_torch.models import cost, pso
    from ndtpso_slam_tpu_torch.ops import score_variants as sv

    wd = pv.world(dev)
    _, u_p = pso._batch_draws(wd["keys"], None, pv.P, torch.float32, dev, "threefry")
    poses = wd["guesses"][:, None, :] + (2.0 * u_p - 1.0) * wd["devs"][:, None, :]
    bound = cost.bind_points(wd["guesses"], wd["snaps"], wd["points"], wd["valid"],
                             wd["map_cfg"])
    phit = sv.pad16(cost.pose_features_t(poses, bound.bind_pose), 1).contiguous()
    return phit, sv.pad16(bound.w, 2).contiguous(), bound.mask.contiguous()


def studies(cs, dev, out):
    """E1-E3 (csrc/score_variants.cu) and the controls K1, K2, K3, E7."""
    from ndtpso_slam_tpu_torch.experiments import kernel_variants as kv
    from ndtpso_slam_tpu_torch.experiments import pallas_variants as pv
    from ndtpso_slam_tpu_torch.experiments import rollout_bisect as rbx
    from ndtpso_slam_tpu_torch.experiments import rollout_score_variants as rsv
    from ndtpso_slam_tpu_torch.ops import _build
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.ops import score as sc
    from ndtpso_slam_tpu_torch.ops import score_variants as sv

    _build.build(sv.LIB, rl.LIB, ro.LIB, rb.LIB, sc.LIB)  # before any timing
    log = sv.LIB.path().with_suffix(".log")
    out["ptxas"] = cs._ptxas_summary(log.read_text() if log.exists() else "")
    out["sass"] = {k: _sass_mixes(sv.LIB, _build, k) for k in ("variant_kernel", "block_kernel")}
    phit, w, mask = kv.inputs(dev)
    for name, zroute, reduce, tile in kv.CONFIGS:
        key = "e1_" + name.split()[0]
        fn = lambda: sv.score_variants(phit, w, mask, zroute, reduce, tile)
        _study_split(cs, key, fn, 20, PROFILE_CALLS, out)
        out[f"{key}_host_us"] = _host_us(fn)[0]
    phit, w, mask = _e2_operands(dev)
    for name, (zroute, reduce) in pv.VARIANTS.items():
        for tile in pv.TILES:
            key = f"e2_{name}_t{tile}"
            fn = lambda: sv.score_variants(phit, w, mask, zroute, reduce, tile)
            _study_split(cs, key, fn, 20, PROFILE_CALLS, out)
            out[f"{key}_host_us"] = _host_us(fn)[0]
    phit, w = rsv.inputs(dev)
    for name in rsv.VARIANTS:
        _study_split(cs, f"e3_{name}", lambda: sv.score_block(phit, w, rsv.I, name), 3, 5, out)
        if getattr(sv.score_block, "LAST", None) is not None:
            out[f"e3_{name}_launch"] = dict(sv.score_block.LAST)
    del phit, w, mask
    world = cs.batch_world(256, dev)
    packed = cs._packed(world)
    out["k2_f32_b256_ms"] = cs._events_ms(lambda: ro.pso_rollout(*packed), 3)
    ops = cs._score_inputs(world, 256)
    out["k3_b256_ms"] = cs._events_ms(lambda: sc.fused_bound_scores(*ops), 20)
    out["k3_sass"] = _k3_sass(sc, _build)
    del packed, ops
    small = cs._first(world, 16)
    ps, pl = cs._packed(small), cs._packed(small, local=True)
    out["k2_f32_b16_ms"] = cs._events_ms(lambda: ro.pso_rollout(*ps), 3)
    out["k1_turbo_b16_ms"] = cs._events_ms(lambda: rl.pso_rollout_local(*pl, rng_mode="native"), 3)
    del ps, pl
    args = rbx.binding_inputs(dev, b=256, n=384)
    out["e7_stage3_ms"] = cs._events_ms(
        lambda: rb.rollout_bisect(3, *args, population=4096, iterations=50), 3)


def measure(root: str, clusters: bool, probes_only: bool, studies_only: bool = False,
            step_only: bool = False) -> dict:
    """The numbers of one checkout, imported from root."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ndtpso_slam_tpu_torch.experiments import rollout_bisect as rbx
    from ndtpso_slam_tpu_torch.ops import _build
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.ops import rollout_bisect as rb
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl
    from ndtpso_slam_tpu_torch.ops import score as sc

    for mod in (cs, ro):
        if not os.path.abspath(mod.__file__).startswith(root):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    from ndtpso_slam_tpu_torch.ops import probes
    from ndtpso_slam_tpu_torch.ops import row_scatter as rsc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"root": root, "card": _smi()}
    if studies_only:
        studies(cs, dev, out)
        return out
    if probes_only:
        _build.build(probes.LIB)
        _e5_e6(cs, dev, out)
        return out
    # Every library before any timing.
    _build.build(*((rl.LIB,) if step_only else (rl.LIB, ro.LIB, rb.LIB, sc.LIB, rsc.LIB,
                                                 probes.LIB)))
    for key in ("scans_s", "step_p50_ms", "step_p95_ms"):
        out[key] = []
    for _ in range(STEP_RUNS):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            node, lg = cs.phase_main()[:2]
        m = re.search(r"([\d.]+) scans/s; aligned-step latency p50 ([\d.]+) ms p95 ([\d.]+) ms",
                      buf.getvalue())
        for key, x in zip(("scans_s", "step_p50_ms", "step_p95_ms"), m.groups()):
            out[key].append(float(x))
    args = _k1_next_solve(cs, node, lg)
    out["k1_b1_ms"] = cs._events_ms(lambda: rl.pso_rollout_local(*args), 50)
    out["k1_b1_host_us"], out["k1_b1_call_sync_us"] = _host_us(lambda: rl.pso_rollout_local(*args))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.phase_main_profile(node, lg)
    out["step_kernels_per_scan"] = float(
        re.search(r"([\d.]+) device kernels per scan", buf.getvalue()).group(1))
    if step_only:
        return out

    world = cs.batch_world(256, dev)
    packed = cs._packed(world)
    out["k2_f32_b256_ms"] = cs._events_ms(lambda: ro.pso_rollout(*packed), 3)
    out["k2_turbo_ee2_b256_ms"] = cs._events_ms(
        lambda: ro.pso_rollout(*packed, rng_mode="native", early_exit=2), 3)
    ops = cs._score_inputs(world, 256)
    out["k3_b256_ms"] = cs._events_ms(lambda: sc.fused_bound_scores(*ops), 20)
    out["k3_sass"] = _k3_sass(sc, _build)
    del ops
    small = cs._first(world, 16)
    ps, pl = cs._packed(small), cs._packed(small, local=True)
    out["k2_f32_b16_ms"] = cs._events_ms(lambda: ro.pso_rollout(*ps), 3)
    out["k2_bf16_b16_ms"] = cs._events_ms(lambda: ro.pso_rollout(*ps, score_dtype="bf16"), 3)
    out["k1_turbo_b16_ms"] = cs._events_ms(lambda: rl.pso_rollout_local(*pl, rng_mode="native"), 3)
    del packed, ps, pl
    args = rbx.binding_inputs(dev, b=256, n=384)
    for s in (1, 2, 3):
        out[f"e7_stage{s}_ms"] = cs._events_ms(
            lambda: rb.rollout_bisect(s, *args, population=4096, iterations=50), 3)
    if clusters and hasattr(ro, "smem_bytes"):
        _cluster_times(cs, rl, ro, small, out)
    _e4(cs, dev, out)
    _e5_e6(cs, dev, out)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = [a for a in argv if a in ("--clusters", "--probes", "--studies", "--step")]
    argv = [a for a in argv if a not in flags]
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(argv[1], "--clusters" in flags, "--probes" in flags,
                                 "--studies" in flags, "--step" in flags)))
        return 0
    for root in map(os.path.abspath, argv):
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root]
        res = subprocess.run(cmd + flags, cwd=root,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
