"""A SLAM state as a dict of numpy arrays, and back.

This system has no model weights: the map and the align bookkeeping are what
a run carries from one scan to the next.  The dict is keyed by the JAX
package's field paths (``map.mean_c``, ``map.slot_sum``, ``align.prev_pose``,
``pose``, ``step``, ``prev_ids``, ``og.og``, ``og.min_x``, ...), so a state
taken from either implementation can continue in the other.  A state without
an occupancy grid has no ``og.*`` keys.  Map arrays hold the real rows only:
C per cell, and the ring's slot arrays C rows (dense) or ``ring_rows`` (a
sparse ring, whose ``map.ring_map`` has C entries); the port's spare scatter
row (see ``models/ndt_map.py``) is added on the way in and dropped on the
way out.

A stacked fleet state (``models/slam.py:init_slam_batch``) goes under the
same paths with a leading [B] axis (:func:`fleet_state_to_numpy`,
:func:`fleet_state_from_numpy`), as the JAX package's ``init_slam_batch``
stacks its leaves, so a JAX fleet state can continue in the port's fleet
and the reverse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ndtpso_slam_tpu_torch.config import SlamConfig, resolve_device
from ndtpso_slam_tpu_torch.models import ndt_map, occupancy
from ndtpso_slam_tpu_torch.models.slam import (
    AlignState,
    SlamState,
    init_slam_batch,
    session_state,
    set_session_state,
)

_SLOTS = ("slot_sum", "slot_count", "slot_cov")
_OG_BOUNDS = ("min_x", "max_x", "min_y", "max_y")


def snapshot_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> ndt_map.MapSnapshot:
    """A map snapshot on ``device`` from {"mean", "inv_cov", "built"} numpy
    arrays, one snapshot ([C, ...]) or a stack of them ([B, C, ...], as
    ``solve_batch`` takes)."""
    dev = resolve_device(device)
    return ndt_map.MapSnapshot(
        **{k: torch.from_numpy(np.array(arrays[k])).to(dev) for k in ("mean", "inv_cov", "built")}
    )


def _map_rows(name: str, cfg: SlamConfig):
    """The real rows of map field ``name`` under ``cfg`` (its leading axis
    without the spare row), or None for a field without one: the 0-d
    counters and a dense ring's empty ``ring_map``."""
    c, r = cfg.map.num_cells, cfg.map.ring_rows
    if name in ("ring_used", "ring_overflow") or (name == "ring_map" and r == 0):
        return None
    return r if name in _SLOTS and r > 0 else c


def _state_items(state: SlamState):
    """(JAX field path, value) of every field of the state: tensors as views
    without the spare row, the host counters as int32 numpy scalars."""
    for f in dataclasses.fields(ndt_map.NdtMapState):
        v = getattr(state.map, f.name)
        # Every map field with rows carries the spare one.
        yield f"map.{f.name}", v[:-1] if v.dim() and v.shape[0] else v
    yield "align.prev_pose", state.align.prev_pose
    yield "align.pose_diff", state.align.pose_diff
    yield "align.iter", np.asarray(state.align.iter, np.int32)
    yield "pose", state.pose
    yield "step", np.asarray(state.step, np.int32)
    yield "fitness", state.fitness
    yield "recoveries", np.asarray(state.recoveries, np.int32)
    yield "prev_ids", state.prev_ids
    if state.og is not None:
        yield "og.og", state.og.og
        for name in _OG_BOUNDS:
            yield f"og.{name}", getattr(state.og, name)


def _numpy(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def slam_state_to_numpy(state: SlamState) -> Dict[str, np.ndarray]:
    """The state as {JAX field path: numpy array}."""
    return {k: _numpy(v) for k, v in _state_items(state)}


def slam_state_layout(state: SlamState) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{JAX field path: (shape, numpy dtype string)} of
    :func:`slam_state_to_numpy`'s arrays, without copying them."""
    out = {}
    for k, v in _state_items(state):
        dtype = (torch.empty((), dtype=v.dtype).numpy().dtype if isinstance(v, torch.Tensor)
                 else v.dtype)
        out[k] = (tuple(v.shape), dtype.str)
    return out


def slam_state_from_numpy(
    arrays: Dict[str, np.ndarray], cfg: SlamConfig, device="cuda"
) -> SlamState:
    """Build a port SlamState on ``device`` from {JAX field path: array}."""
    dev = resolve_device(device)

    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(dev)

    fields = {}
    for f in dataclasses.fields(ndt_map.NdtMapState):
        v = t(f"map.{f.name}")
        rows = _map_rows(f.name, cfg)
        if rows is not None:
            if v.ndim == 0 or v.shape[0] != rows:
                raise ValueError(f"map.{f.name} has shape {tuple(v.shape)}, the config needs "
                                 f"{rows} rows (cells {cfg.map.num_cells}, ring_rows "
                                 f"{cfg.map.ring_rows})")
            v = torch.cat([v, torch.full_like(v[:1], -1 if f.name == "ring_map" else 0)])
        elif f.name == "ring_map" and v.numel():
            raise ValueError(f"map.ring_map has {v.numel()} entries: a sparse-ring state, "
                             "the config has a dense ring (ring_rows 0)")
        fields[f.name] = v
    if ("og.og" in arrays) != cfg.og.enabled:
        raise ValueError(f"the arrays {'carry' if 'og.og' in arrays else 'lack'} an occupancy "
                         f"grid, the config has og.enabled={cfg.og.enabled}")
    og = None
    if cfg.og.enabled:
        og = occupancy.grid_from_raster(t("og.og"), *(arrays[f"og.{k}"] for k in _OG_BOUNDS))
    return SlamState(
        map=ndt_map.NdtMapState(**fields),
        align=AlignState(
            prev_pose=t("align.prev_pose"), pose_diff=t("align.pose_diff"),
            iter=int(arrays["align.iter"]),
        ),
        og=og,
        pose=t("pose"),
        step=int(arrays["step"]),
        fitness=t("fitness"),
        recoveries=int(arrays["recoveries"]),
        prev_ids=t("prev_ids").to(torch.int32),
    )


def fleet_state_to_numpy(states: SlamState) -> Dict[str, np.ndarray]:
    """A stacked state as {JAX field path: numpy array [B, ...]}: each
    session's :func:`slam_state_to_numpy`, stacked."""
    per = [slam_state_to_numpy(session_state(states, i)) for i in range(states.pose.shape[0])]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def fleet_state_from_numpy(
    arrays: Dict[str, np.ndarray], cfg: SlamConfig, device="cuda"
) -> SlamState:
    """Build a stacked port state on ``device`` from {JAX field path: array
    [B, ...]}, each session checked as :func:`slam_state_from_numpy` checks
    a solo state."""
    states = init_slam_batch(cfg, np.asarray(arrays["pose"]), device)
    for i in range(states.pose.shape[0]):
        one = slam_state_from_numpy({k: np.asarray(v)[i] for k, v in arrays.items()}, cfg, device)
        view = session_state(states, i)
        for f in dataclasses.fields(ndt_map.NdtMapState):
            getattr(view.map, f.name).copy_(getattr(one.map, f.name))
        if one.og is not None:
            view.og.buf.copy_(one.og.buf)
        set_session_state(states, i, one)
    return states
