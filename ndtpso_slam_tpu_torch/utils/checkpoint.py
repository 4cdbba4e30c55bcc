"""Checkpoint and resume of a SLAM state.

The reference can only export a map at shutdown; a map cannot be resumed.
Here the whole ``SlamState`` (the map's window statistics and, for a sparse
ring, its cell-to-row table ``map.ring_map`` with ``map.ring_used`` and
``map.ring_overflow``; the occupancy raster; the align bookkeeping; the
pose and step) is saved as the arrays of ``utils/state.py``, keyed by the
JAX package's field paths, in one ``.npz`` with a JSON descriptor: the
format name and version, and the shape and dtype of every array.

This is the port's own format.  The JAX package's checkpoints key the same
arrays by pytree key path (``.map.mean_c``), and its v1 files are read by a
tree structure only JAX has; neither is read here.

:func:`restore` checks the file against the state it restores into (its
configuration: frame size, cell side, window slots, ring rows, beam count,
occupancy grid on or off) and raises ValueError naming the first key whose
presence, shape or dtype differs.
"""

from __future__ import annotations

import json

import numpy as np

from ndtpso_slam_tpu_torch.config import SlamConfig
from ndtpso_slam_tpu_torch.models.slam import SlamState
from ndtpso_slam_tpu_torch.utils.state import (
    slam_state_from_numpy,
    slam_state_layout,
    slam_state_to_numpy,
)

FORMAT = "ndtpso-slam-state"
FORMAT_VERSION = 1
_DESCRIPTOR = "__descriptor__"


def save(path: str, state: SlamState) -> None:
    """Save ``state`` to ``path`` (.npz; numpy adds the suffix if missing)."""
    arrays = slam_state_to_numpy(state)
    desc = {"format": FORMAT, "version": FORMAT_VERSION,
            "arrays": {k: {"shape": list(v.shape), "dtype": v.dtype.str}
                       for k, v in arrays.items()}}
    np.savez_compressed(path, **arrays,
                        **{_DESCRIPTOR: np.frombuffer(json.dumps(desc).encode(), np.uint8)})


def _check(desc: dict, files, like: SlamState, path: str) -> None:
    if desc.get("format") != FORMAT or desc.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: format {desc.get('format')!r} version "
                         f"{desc.get('version')!r}, expected {FORMAT!r} {FORMAT_VERSION}")
    saved = desc["arrays"]
    want = slam_state_layout(like)
    stored = set(files) - {_DESCRIPTOR}
    for key in sorted(set(want) | set(saved) | stored):
        if key not in want:
            raise ValueError(f"checkpoint key {key!r} is not a field of the restoring state")
        if key not in saved or key not in stored:
            raise ValueError(f"checkpoint lacks key {key!r} of the restoring state")
        shape, dtype = tuple(saved[key]["shape"]), saved[key]["dtype"]
        if (shape, dtype) != want[key]:
            raise ValueError(
                f"checkpoint key {key!r}: shape {shape} dtype {dtype}, the restoring state "
                f"has shape {want[key][0]} dtype {want[key][1]}: its configuration (frame "
                "size, cell side, window slots, ring rows, beam count, occupancy grid on or "
                "off) must be the one that saved the checkpoint")


def restore(path: str, like: SlamState, cfg: SlamConfig, device=None) -> SlamState:
    """The state saved in ``path``, on ``device`` (default: ``like``'s),
    checked key by key against ``like``, a state of configuration ``cfg``."""
    with np.load(path) as data:
        if _DESCRIPTOR not in data.files:
            raise ValueError(f"{path}: no {_DESCRIPTOR}: not a checkpoint of this format")
        desc = json.loads(bytes(data[_DESCRIPTOR]).decode())
        _check(desc, data.files, like, path)
        arrays = {k: data[k] for k in desc["arrays"]}
    for key, (shape, dtype) in slam_state_layout(like).items():
        if (arrays[key].shape, arrays[key].dtype.str) != (shape, dtype):
            raise ValueError(f"checkpoint key {key!r}: stored array has shape "
                             f"{arrays[key].shape} dtype {arrays[key].dtype.str}, its "
                             f"descriptor says {shape} {dtype}")
    return slam_state_from_numpy(arrays, cfg, like.pose.device if device is None else device)
