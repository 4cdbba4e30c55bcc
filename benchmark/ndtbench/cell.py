"""A benchmark cell, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; each lives in a file of its own
(``configs/<config>.json``, ``traffic/<traffic>.json``), and each per-layer
metric is a reader of its own (``metrics/<name>.py``, a function
``read(view)`` that returns a number, or None where it finds nothing to
read).  No file lists them: a cell is added by adding its files and its
entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def reads(self, trace: bool) -> List[dict]:
        """The metrics a run reports: the per-layer ones with ``trace``, else
        the end-to-end ones, each where its ``workloads`` name this cell (a
        metric without the key in every cell)."""
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", [self.name])]


def load(name: str, root: Path = ROOT, overrides: Optional[dict] = None) -> Cell:
    """Cell ``name`` of ``root/BENCHMARK.json``, with ``overrides``
    ({"config": {...}, "traffic": {...}}, tests only) merged into its
    files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    over = overrides or {}
    return Cell(
        name=name, config_name=w["config"],
        config=_merge(json.loads((root / config["file"]).read_text()), over.get("config")),
        traffic_name=w["traffic"],
        traffic=_merge(json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
                       over.get("traffic")),
        end_to_end=spec["end_to_end"], per_layer=spec["per_layer"],
    )


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"ndtbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], view) -> Dict[str, dict]:
    """Each metric its reader finds, as {name: {"value", "unit"}}."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
