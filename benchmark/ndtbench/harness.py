"""One run of one cell: set-up, the window, the judge, the result line.

``run.py`` is the command; :func:`run_cell` is the run without the look for
a chip, which the CPU tests drive at small sizes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import List, Optional

import numpy as np

from ndtbench import cell as cellmod
from ndtbench import drivers
from ndtbench import judge as J

# Top-level module names the run must not hold once its window has closed:
# the JAX stack and the JAX package (compared as whole names: the program's
# package name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "ndtpso_slam_tpu")


@dataclasses.dataclass
class Context:
    """What a metric's reader reads: the window's durations and counts, and
    with ``--trace 1`` the traced window (``trace.View``), else None.
    ``events``: the node's kidnap and accepted-relocalization steps
    (``drivers.Run.events``), None for batch matching; ``step_busy_s``:
    the card's busy seconds within each step of a kidnap log's untraced
    window (``drivers.Run.step_busy_s``), else None."""

    kind: str
    units: int
    per_unit: int
    durations: List[float]
    window_s: float
    setup_s: float
    trace: object
    card_busy_s: Optional[float] = None  # CUPTI's busy time over the window
    events: Optional[dict] = None
    step_busy_s: Optional[List[float]] = None


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(device, count: int, mem: int, view) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": count}
    info["memory_peak_bytes"] = int(mem)
    if view is not None:
        info["busy_s"] = view.busy_s
        info["window_s"] = view.window_s
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t0: float,
             chips: int = 1, overrides: Optional[dict] = None, control: bool = False) -> dict:
    """The result of one run (module docstring): ``attempted`` counts the
    window's scans or calls, ``failed`` the compared numbers over their
    limits.  With ``control`` the judge reads the precision control's
    answers in the program's place."""
    cell = cellmod.load(workload, overrides=overrides)
    kind = cell.config["entry"]
    run = drivers.DRIVERS[kind](cell, seed, seconds, trace, device, t0)
    verdict = run.judge(control)
    numbers = verdict["numbers"]
    limits = cell.config.get("limits", {})
    chk = J.checks(numbers, limits)
    ctx = Context(kind=kind, units=run.attempted, per_unit=run.per_unit,
                  durations=run.durations, window_s=run.window_s, setup_s=run.setup_s,
                  trace=run.view, card_busy_s=run.card_busy_s, events=run.events,
                  step_busy_s=run.step_busy_s)
    result = {
        "correct": J.passed(chk),
        "attempted": run.attempted,
        "failed": sum(1 for c in chk.values() if not J.passed({"c": c})),
        "metrics": cellmod.read_metrics(cell.reads(trace), ctx),
        "device": device_info(device, chips, run.memory_peak, run.view),
    }
    if run.view is not None:
        result["breakdown"] = run.view.breakdown
        result["trace_windows"] = run.view.tries
    result["checks"] = chk
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(_finite(result)))


def _finite(x):
    """The result with every number a plain float and every non-finite one
    None (JSON has no NaN or infinity)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x) if math.isfinite(x) else None
    return x
