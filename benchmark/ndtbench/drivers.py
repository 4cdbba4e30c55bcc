"""The two ways users drive the program, one driver each, chosen by the
configuration's ``entry``:

* ``node``: one SLAM node (``SlamNode.process_scan``) fed a sensor's scans
  one after another, a closed loop of one caller: each scan goes in when the
  last pose has come back to the host.  Set-up makes one lap of the traffic
  and runs ``warmup_laps`` laps of it through the node (which builds the
  map); the window plays the lap on as the traffic's schedule says (in
  order, or with kidnaps: ``synthetic.NODE_TRAFFIC``), with the timestamps
  running on.  A node with recovery on takes the configuration's
  ``recovery`` block, which must state the node's own parameters
  (:func:`recovery_block`); the run records the steps at which the node
  accepted a relocalization.  A kidnap log's set-up plays
  ``WARMUP_KIDNAPS`` kidnaps after the laps, so the relocalization's
  kernels are built and loaded before the window; its untraced window on
  the card records the card's busy time within each step (CUPTI, a mark
  before each step).
* ``solve_batch``: a batch matcher that keeps one ``solve_batch`` call in
  flight and needs each call's poses and costs on the host.  Set-up makes
  the pool of scan pairs, builds each world's map (the benchmark's own
  reference map in float64, handed to the program as float32), stages
  every input and a fresh key block per call on the device, and warms the
  call up; in the window, call k solves the pool's rows from
  (k·B) mod pool with key block k.

Each driver returns a :class:`Run`: what the window measured (one duration
per scan or call; for the node on the card, also CUPTI's busy time over
the window, and for a kidnap log within each step), with ``trace`` the
traced window's :class:`View` (the node then times a plain window after
it), and a ``judge()`` that, after the program's state is freed, runs the
reference over what the window produced.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ndtbench import judge as J
from ndtbench import reference as R
from ndtbench import cupti, synthetic, trace as T

# Key blocks staged per second of window: one call every B/16 ms (a
# call of B solves taking B/16 ms or more); a faster program wraps around
# them, and repeats a key block's answers.
CALLS_PER_SECOND_PER_16 = 1024
# The most of a window's busy time that may lie in device records crossing
# from one step into the next, whose split between the two steps is then
# a matter of where the mark fell.
CROSSING_MAX = 0.01
# Kidnaps a kidnap log's set-up plays after its laps (one every
# kidnap_every scans), so that the relocalization's kernels are built and
# loaded before the window.
WARMUP_KIDNAPS = 2


@dataclasses.dataclass
class Run:
    attempted: int
    durations: List[float]  # seconds per scan or call in the window
    window_s: float
    setup_s: float
    view: Optional[T.View]
    memory_peak: int
    judge: Callable[..., dict]  # (control, witness) -> {"numbers", "samples", "witnesses", ...}
    per_unit: int  # solves per call (1 for the node)
    card_busy_s: Optional[float] = None  # the card's busy time over the whole window
    # The node's: {"kidnaps", "accepted"}: the window's steps at which the
    # log jumped and at which the node accepted a relocalization;
    # "timed_from": the step whose host time is durations[0].  None for
    # batch matching.
    events: Optional[dict] = None
    # A kidnap log's untraced window on the card: the card's busy seconds
    # within each step, as durations are taken (step timed_from + i).
    step_busy_s: Optional[List[float]] = None


def on_card(device) -> bool:
    """Whether the node's untraced window records the card (CUPTI)."""
    return torch.device(device).type == "cuda"


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def timed(step: Callable[[], None], seconds: float):
    """Call step() until ``seconds`` have passed: (durations, window s)."""
    durations = []
    start = time.perf_counter()
    now = start
    while now - start < seconds:
        step()
        t = time.perf_counter()
        durations.append(t - now)
        now = t
    return durations, now - start


# --------------------------------------------------------------------- node


# The fields of the node's RecoveryConfig that a configuration's ``recovery``
# block states and the judge's reference reads.
RECOVERY_KEYS = ("fitness_threshold", "accept_fitness", "spread", "grid", "grid_sigma",
                 "refine_sigma", "grid_beam_stride", "k_hypotheses", "deviation", "patch_cells",
                 "pso", "min_valid_beams")


def recovery_block(config: dict, rc) -> Optional[dict]:
    """The configuration's ``recovery`` block where the node's recovery
    (``rc``, its RecoveryConfig) is on, else None.  Raises ValueError where
    the block is missing, is given with recovery off, or differs from ``rc``
    in any of RECOVERY_KEYS: the program and the judge never work from
    different parameters."""
    block = config.get("recovery")
    if not rc.enabled:
        if block is not None:
            raise ValueError("the configuration has a recovery block but the node's recovery "
                             "is off")
        return None
    if block is None:
        raise ValueError("the node's recovery is on but the configuration has no recovery block")
    differ = []
    for k in RECOVERY_KEYS:
        want = getattr(rc, k)
        want = dataclasses.asdict(want) if k == "pso" else want
        got = block.get(k)
        got = tuple(got) if isinstance(want, tuple) and isinstance(got, list) else got
        if got != want:
            differ.append(f"{k}: block {got!r}, node {want!r}")
    if differ:
        raise ValueError("the recovery block differs from the node's RecoveryConfig: "
                         + "; ".join(differ))
    return block


def run_node(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode
    from ndtpso_slam_tpu_torch.ops import rollout_local as rl

    p, c = cell.traffic, dict(cell.config["node"])
    lap, sched = synthetic.NODE_TRAFFIC[p["kind"]](p, seed)
    b = lap.beams
    n_lap = lap.ranges.shape[0]
    ncfg = NodeConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in c.items()},
                      seed=seed)
    node = SlamNode(ncfg, verbose=False, device=device)
    rc = node.slam_cfg.recovery
    block = recovery_block(cell.config, rc)
    poses, fitness, accepted = [], [], []

    def step():
        t = len(poses)
        before = node.state.recoveries
        poses.append(node.process_scan(lap.ranges[sched.index(t)], b.angle_min,
                                       b.angle_increment, b.range_max, timestamp=t * lap.dt))
        fitness.append(node.state.fitness)
        if node.state.recoveries != before:
            accepted.append(t)

    kidnap_log = p["kind"] == "kidnap_log"
    warmup = int(p["warmup_laps"]) * n_lap
    if kidnap_log:  # the schedule's jumps begin after the laps
        warmup += WARMUP_KIDNAPS * int(p["kidnap_every"])
    for _ in range(warmup):
        step()
    sync(device)
    setup_s = time.perf_counter() - t0
    first = len(poses)
    view, card_busy_s, step_busy_s = None, None, None
    if trace:
        steps = int(p["trace_steps"])

        def window():
            for _ in range(steps):
                with torch.profiler.record_function("node.process_scan"):
                    step()
            return steps

        shape = dict(batch=1, n_pts=int(c["max_beams"]), population=int(c["pso_population"]),
                     iterations=int(c["pso_iterations"]))
        if block is not None:  # K3's launches in the relocalization's swarms
            shape["k3"] = dict(batch=rc.k_hypotheses, n_pts=int(c["max_beams"]),
                               population=rc.pso.population)
        view = T.traced(window, lambda: rl.pso_rollout_local.LAUNCHES,
                        lambda name: "rollout_local" in name, "node", shape)
        # The host's rate and tail, per layer: a window with nothing recorded.
        durations, window_s = timed(step, seconds)
    elif on_card(device):
        # The card's busy time over the window: CUPTI records every device
        # operation (it slows the host's launches, not the card).
        clock = cupti.DeviceClock()
        marked = (lambda: (clock.mark(), step())) if kidnap_log else step
        clock.start(lambda: sync(device))
        durations, window_s = timed(marked, seconds)
        clock.stop(lambda: sync(device))
        card_busy_s = clock.busy_s
        print(f"card: {clock.kernels} kernels, {clock.ops} device operations "
              f"({clock.left_out} untimed), busy {card_busy_s!r} s over {len(durations)} scans",
              file=sys.stderr)
        if kidnap_log:
            # Each step ends once its pose is on the host (pose.cpu()), so
            # its device work ends inside it.
            step_busy_s = clock.busy_between(clock.marks).tolist()
            share = clock.crossing_share(clock.marks)
            print(f"card: {len(clock.marks)} step marks, {share!r} of the busy time in "
                  f"records across a mark (at most {CROSSING_MAX!r})", file=sys.stderr)
            if len(step_busy_s) != len(durations) or share > CROSSING_MAX:
                raise RuntimeError(f"the card's time per step cannot be told apart: "
                                   f"{len(step_busy_s)} steps marked of {len(durations)}, "
                                   f"{share!r} of the busy time across a mark")
    else:
        durations, window_s = timed(step, seconds)
    mem = peak(device)
    timed_from = len(poses) - len(durations)  # the timed window's steps come last
    served = np.stack(poses)
    fit = torch.stack(fitness).cpu().numpy().astype(np.float64)
    st = node.state
    n_cells = int(round(c["frame_size_m"] / c["cell_side_m"])) ** 2
    final_map = {"mean": st.map.mean_c[:n_cells].clone(), "icov": st.map.inv_cov[:n_cells].clone(),
                 "built": st.map.built[:n_cells].clone()}
    raster = st.og.og.clone() if st.og is not None else None
    del node, st, fitness
    free(device)
    grid = R.Grid(float(c["frame_size_m"]), float(c["cell_side_m"]))
    final_map["mean"] = (grid.centers(torch.arange(n_cells, device=final_map["mean"].device),
                                      torch.float64) + final_map["mean"].double())
    rng = np.random.default_rng([seed, 1])
    window_steps = np.arange(first, len(served))
    kidnaps = sched.kidnaps(first, len(served))
    sampled_kidnaps = []
    if block is not None and kidnaps:
        # Kidnaps and the step after each are judged apart (judge.py).
        sampled_kidnaps = J.sample_rows(np.random.default_rng([seed, 4]), kidnaps,
                                        int(p["sample_events"])).tolist()
        apart = set(kidnaps) | {t + 1 for t in kidnaps}
        window_steps = np.asarray([t for t in window_steps if t not in apart], np.int64)
    sample = sorted(set(range(min(4, first))) |
                    set(J.sample_rows(rng, window_steps, int(p["sample_steps"])).tolist()))
    index = [sched.index(t) for t in range(len(served))]

    def judge(control=False, witness=False):
        return J.judge_node(lap, c, cell.config["parted"], seed, served, fit, final_map, raster,
                            sample, device, control=control, witness=witness, index=index,
                            recovery=block, accepted=accepted, events=sampled_kidnaps)

    events = {"kidnaps": kidnaps, "accepted": [t for t in accepted if t >= first],
              "timed_from": timed_from}
    return Run(attempted=len(served) - first, durations=durations, window_s=window_s,
               setup_s=setup_s, view=view, memory_peak=mem, judge=judge, per_unit=1,
               card_busy_s=card_busy_s, events=events, step_busy_s=step_busy_s)


# -------------------------------------------------------------------- batch


def stage_pairs(pool: synthetic.PairPool, cfg: dict, device) -> dict:
    """The pool on the device as both sides take it: each world's map built
    by the reference in float64 from its jittered observations, then
    rounded to float32; the query scans' points in float32."""
    m = cfg["map"]
    grid = R.Grid(float(m["size_m"]), float(m["cell_side_m"]))
    f64 = torch.float64
    snaps = []
    for w in range(pool.ref_points.shape[0]):
        nmap = R.NdtMap(grid, int(m["window_slots"]), f64, device)
        valid = torch.as_tensor(pool.ref_valid[w], device=device)
        for s in range(pool.ref_points.shape[1]):
            nmap.add(torch.as_tensor(pool.ref_points[w, s], device=device).to(f64), valid)
            nmap.build(torch.arange(grid.cells, device=device))
        snaps.append(nmap.snapshot())
    world = torch.as_tensor(pool.world, device=device)
    mean = torch.stack([s[0] for s in snaps]).float()[world].contiguous()
    icov = torch.stack([s[1] for s in snaps]).float()[world].contiguous()
    built = torch.stack([s[2] for s in snaps])[world].contiguous()
    b = pool.beams
    pts, valid = R.scan_points(pool.query_ranges, b.angle_min, b.angle_increment, b.range_max,
                               int(cfg["max_beams"]), None, torch.float32, device,
                               frame_half=float(m["size_m"]) / 2)
    n = pool.true.shape[0]
    guess = torch.zeros((n, 3), dtype=torch.float32, device=device)
    dev = torch.tensor(cfg["deviation"], dtype=torch.float32, device=device).expand(n, 3)
    return dict(mean=mean, icov=icov, built=built, points=pts.contiguous(),
                valid=valid.contiguous(), guess=guess, dev=dev.contiguous())


def run_batch(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    from ndtpso_slam_tpu_torch import config as C
    from ndtpso_slam_tpu_torch.models.ndt_map import MapSnapshot
    from ndtpso_slam_tpu_torch.ops import rollout as ro
    from ndtpso_slam_tpu_torch.parallel import mesh

    p, c = cell.traffic, cell.config
    b, pool_n = int(p["batch"]), int(p["pool"])
    pool = synthetic.pair_pool(p, seed)
    inp = stage_pairs(pool, dict(c, deviation=p["deviation"]), device)
    m = c["map"]
    map_cfg = C.MapConfig(size_m=float(m["size_m"]), cell_side_m=float(m["cell_side_m"]),
                          window_slots=int(m["window_slots"]))
    pso_cfg = C.PSOConfig(iterations=int(c["pso"]["iterations"]),
                          population=int(c["pso"]["population"]))
    n_keys = max(16, int(np.ceil(max(seconds, 1.0) * CALLS_PER_SECOND_PER_16 * 16 / b)))
    rng = np.random.default_rng([seed, 2])
    words = rng.integers(0, 2**32, (n_keys, b, 2), dtype=np.uint64)
    keys = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)
    calls: list = []

    def solve(k, mode, pso=pso_cfg):
        """Call k: the pool's rows from (k·B) mod pool, key block k."""
        rows = slice((k * b) % pool_n, (k * b) % pool_n + b)
        return mesh.solve_batch(keys[k % n_keys], inp["guess"][rows], inp["dev"][rows],
                                MapSnapshot(inp["mean"][rows], inp["icov"][rows],
                                            inp["built"][rows]),
                                inp["points"][rows], inp["valid"][rows], map_cfg, pso, mode)

    def call():
        res = solve(len(calls), c["cost_mode"])
        calls.append((res.pose.cpu().numpy(), res.cost.cpu().numpy()))

    for _ in range(int(p["warmup_calls"])):
        call()
    sync(device)
    setup_s = time.perf_counter() - t0
    first = len(calls)
    view, durations, window_s = None, [], 0.0
    if trace:
        n_calls = int(p["trace_calls"])

        def window():
            for _ in range(n_calls):
                with torch.profiler.record_function("batch.solve_batch"):
                    call()
            return n_calls

        view = T.traced(window, lambda: ro.pso_rollout.LAUNCHES,
                        lambda name: "rollout_kernel" in name, "batch",
                        dict(batch=b, n_pts=int(c["max_beams"]), population=pso_cfg.population,
                             iterations=pso_cfg.iterations))
        first = len(calls) - n_calls
    else:
        durations, window_s = timed(call, seconds)
    mem = peak(device)
    srng = np.random.default_rng([seed, 3])
    n_sample = int(p["sample_solves"])
    picked = J.sample_rows(srng, np.arange(first, len(calls)), n_sample)
    picked = np.resize(picked, n_sample) if len(picked) else picked
    offset = int(srng.integers(0, b))
    sampled, cand_pose, cand_cost, sample_calls = [], [], [], []
    for j, k in enumerate(picked):
        pose, cost = calls[int(k)]
        r = (offset + j * b // n_sample) % b
        sampled.append(((int(k) * b) % pool_n + r, [int(x) for x in words[int(k) % n_keys, r]]))
        cand_pose.append(pose[r])
        cand_cost.append(cost[r])
        sample_calls.append((int(k), r))
    cand_pose, cand_cost = np.asarray(cand_pose), np.asarray(cand_cost)

    def control_answers():
        """The program's own lower-precision path (``control_mode``) on the
        sampled solves' inputs."""
        out_p, out_c = [], []
        for k, r in sample_calls:
            res = solve(k, c["control_mode"])
            out_p.append(res.pose[r].cpu().numpy())
            out_c.append(float(res.cost[r]))
        return np.asarray(out_p), np.asarray(out_c)

    def budgets(j):
        """Sample j's call rerun with each iteration budget 1 .. I (a PSO
        iteration's draws do not depend on the budget): [(pose, cost)]."""
        k, r = sample_calls[j]
        out = []
        for it in range(1, pso_cfg.iterations + 1):
            res = solve(k, c["cost_mode"], dataclasses.replace(pso_cfg, iterations=it))
            out.append((res.pose[r].cpu().numpy(), float(res.cost[r])))
        return out

    def judge(control=False, witness=False):
        cp, cc = control_answers() if control else (cand_pose, cand_cost)
        free(device)
        return J.judge_batch(inp, sampled, cp, cc, c["map"], c["pso"], c["parted"], device,
                             budgets=budgets if witness and not control else None)

    attempted = len(calls) - first
    del calls
    return Run(attempted=attempted, durations=durations, window_s=window_s, setup_s=setup_s,
               view=view, memory_peak=mem, judge=judge, per_unit=b)


DRIVERS = {"node": run_node, "solve_batch": run_batch}
