"""A SLAM state as a dict of numpy arrays, and back.

This system has no model weights: the map and the align bookkeeping are what
a run carries from one scan to the next.  The dict is keyed by the JAX
package's field paths (``map.mean_c``, ``map.slot_sum``, ``align.prev_pose``,
``pose``, ``step``, ``prev_ids``, ...), so a state taken from either
implementation can continue in the other.  Map arrays hold the real cells
only; the port's spare scatter row (see ``models/ndt_map.py``) is added on
the way in and dropped on the way out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ndtpso_slam_tpu_torch.config import SlamConfig, resolve_device
from ndtpso_slam_tpu_torch.models import ndt_map
from ndtpso_slam_tpu_torch.models.slam import AlignState, SlamState

# Map fields whose leading axis is the cell axis (they carry the spare row).
_PER_CELL = tuple(
    f.name for f in dataclasses.fields(ndt_map.NdtMapState)
    if f.name not in ("ring_map", "ring_used", "ring_overflow")
)


def slam_state_to_numpy(state: SlamState) -> Dict[str, np.ndarray]:
    """The state as {JAX field path: numpy array}; ``og`` (always None in the
    port) is left out."""
    out = {}
    for f in dataclasses.fields(ndt_map.NdtMapState):
        v = getattr(state.map, f.name).cpu().numpy()
        out[f"map.{f.name}"] = v[:-1] if f.name in _PER_CELL else v
    out["align.prev_pose"] = state.align.prev_pose.cpu().numpy()
    out["align.pose_diff"] = state.align.pose_diff.cpu().numpy()
    out["align.iter"] = np.asarray(state.align.iter, np.int32)
    out["pose"] = state.pose.cpu().numpy()
    out["step"] = np.asarray(state.step, np.int32)
    out["fitness"] = state.fitness.cpu().numpy()
    out["recoveries"] = np.asarray(state.recoveries, np.int32)
    out["prev_ids"] = state.prev_ids.cpu().numpy()
    return out


def slam_state_from_numpy(
    arrays: Dict[str, np.ndarray], cfg: SlamConfig, device="cuda"
) -> SlamState:
    """Build a port SlamState on ``device`` from {JAX field path: array}."""
    dev = resolve_device(device)
    c = cfg.map.num_cells

    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(dev)

    fields = {}
    for f in dataclasses.fields(ndt_map.NdtMapState):
        v = t(f"map.{f.name}")
        if f.name in _PER_CELL:
            if v.shape[0] != c:
                raise ValueError(f"map.{f.name} has {v.shape[0]} rows, config has {c} cells")
            v = torch.cat([v, torch.zeros_like(v[:1])])
        fields[f.name] = v
    return SlamState(
        map=ndt_map.NdtMapState(**fields),
        align=AlignState(
            prev_pose=t("align.prev_pose"), pose_diff=t("align.pose_diff"),
            iter=int(arrays["align.iter"]),
        ),
        og=None,
        pose=t("pose"),
        step=int(arrays["step"]),
        fitness=t("fitness"),
        recoveries=int(arrays["recoveries"]),
        prev_ids=t("prev_ids").to(torch.int32),
    )
