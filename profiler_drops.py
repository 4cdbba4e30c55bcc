"""T1: where torch.profiler loses device records late in a run.

    python profiler_drops.py

Opens profiled windows of PROFILE_CALLS calls each, as chip_smoke.py's
phase 6f does, of two calls on phase 6f's seeded [8, 512] tile: the E6
probe ``col3`` (one kernel launch per call, counted by its wrapper's
``LAUNCHES``) and its library call ``x + C`` (one PyTorch kernel per call).
For every window it counts the device records the profiler returns against
the launches, and for each recorded kernel it reads two clock gaps on the
profiler's own timestamps:

* lag: the kernel's start minus the start of the runtime call that launched
  it (matched by correlation id).  A kernel cannot start before its launch,
  so a negative lag, or one that grows through the run, is a skew between
  the device's timestamps and the host's;
* end gap: the end of the window's last synchronize call minus the
  kernel's end.  The kernel ends before the synchronize returns, so a
  negative gap is the same skew.

Half of the windows run as chip_smoke.py runs them; the other half wait
PAD_S on the host after the window opens and before it closes.  The
profiler keeps only records that lie inside its window, so if the pad brings
the lost records back, the skew pushed them out.  Stages, in one process:
fresh; after 200 more empty profiler sessions (the session count); after
IDLE_S of idle host (the time since the profiler started);
after BULK_LAUNCHES unprofiled launches of the probe (the launch count);
after one profiled window of BIG_WINDOW launches (a window as large as
phase 5b's ``fast_fused`` call); after chip_smoke.py's phases 1-5, the work
a full run does before phase 6 (their output goes to
``chiprun_out/profiler_drops_phases.log``).
Prints one JSON line per stage, with the card's name and power limit.
Needs one CUDA GPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")
T0 = time.perf_counter()
WINDOWS = 20  # windows per call, stage and pad
PAD_S = 0.020
IDLE_S = 90.0
BULK_LAUNCHES = 100_000
BIG_WINDOW = 20_000


def _spread(xs):
    return [min(xs), statistics.median(xs), max(xs)] if xs else None


def window(call, kernel, wrapper, pad_s, calls):
    """One profiled window of `calls` calls: (launches, recorded kernels
    whose name holds `kernel`, all device records, lags us, end gaps us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = wrapper.LAUNCHES if wrapper is not None else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    launches = wrapper.LAUNCHES - before if wrapper is not None else calls
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    own = [e for e in device if kernel in e.name()]
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    launch_calls = {e.correlation_id(): e for e in host if e.name().startswith("cudaLaunchKernel")}
    syncs = [e for e in host if "Synchronize" in e.name()]
    lags = [(k.start_ns() - launch_calls[k.correlation_id()].start_ns()) / 1e3
            for k in own if k.correlation_id() in launch_calls]
    sync_end = max((e.end_ns() for e in syncs), default=None)
    gaps = [(sync_end - k.end_ns()) / 1e3 for k in own] if sync_end is not None else []
    return launches, len(own), len(device), lags, gaps


def stage(name, calls_by_key, calls):
    out = {"stage": name, "since_start_s": round(time.perf_counter() - T0, 1)}
    for key, (call, kernel, wrapper) in calls_by_key.items():
        for pad in (0.0, PAD_S):
            rows = [window(call, kernel, wrapper, pad, calls) for _ in range(WINDOWS)]
            out[f"{key}_pad{int(pad * 1e3)}ms"] = dict(
                launches=sum(r[0] for r in rows), recorded=sum(r[1] for r in rows),
                device_records=sum(r[2] for r in rows),
                windows_short=sum(r[1] < r[0] for r in rows),
                windows_empty=sum(r[1] == 0 for r in rows),
                matched=sum(len(r[3]) for r in rows),
                lag_us=_spread([x for r in rows for x in r[3]]),
                end_gap_us=_spread([x for r in rows for x in r[4]]))
    print(json.dumps(out), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from ndtpso_slam_tpu_torch.experiments import mosaic_probe as mp
    from ndtpso_slam_tpu_torch.ops import probes
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": cs._smi()}), flush=True)
    dev = torch.device("cuda")
    x, _ = mp.inputs(dev, seed=5)
    c = torch.tensor([1.0, 2.0] + [3.0] * (probes.ROWS - 2), device=dev)[:, None]
    calls = {"col3": (lambda: probes.mosaic_probe("col3", x), "mosaic_kernel_col3",
                      probes.mosaic_probe),
             "x_plus_c": (lambda: x + c, "", None)}
    for call, *_ in calls.values():
        call()
    torch.cuda.synchronize()
    stage("fresh", calls, cs.PROFILE_CALLS)
    for _ in range(200):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            pass
    stage("after 200 empty sessions", calls, cs.PROFILE_CALLS)
    time.sleep(IDLE_S)
    stage(f"after {IDLE_S:g} s idle", calls, cs.PROFILE_CALLS)
    probe = calls["col3"][0]
    for _ in range(BULK_LAUNCHES):
        probe()
    torch.cuda.synchronize()
    stage(f"after {BULK_LAUNCHES} unprofiled launches", calls, cs.PROFILE_CALLS)
    launches, recorded, *_ = window(probe, "mosaic_kernel_col3", probes.mosaic_probe, 0.0, BIG_WINDOW)
    print(json.dumps({"big_window": {"launches": launches, "recorded": recorded}}), flush=True)
    stage(f"after a profiled window of {BIG_WINDOW} launches", calls, cs.PROFILE_CALLS)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "profiler_drops_phases.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        cs.phase_device()
        cs.phase_kernel()
        cs.phase_paths()
        node, lg, _, _ = cs.phase_main()
        cs.phase_main_og(node, lg)
        cs.phase_main_kernel(node, lg)
        cs.phase_main_profile(node, lg)
        world = cs.batch_world(cs.BATCH, dev)
        cs.phase_batch_kernels(world)
        cs.phase_batch(world)
        cs.phase_batch_small(world)
        cs.phase_batch_large(world)
        del world, node
    torch.cuda.synchronize()
    stage("after chip_smoke phases 1-5", calls, cs.PROFILE_CALLS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
