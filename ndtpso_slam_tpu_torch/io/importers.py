"""Scan-log loading.

Port of the ``.npz`` branch of ``load_log`` in
``ndtpso_slam_tpu/io/importers.py``.  The ``.bag``, ``.csv`` and native
``.ndtlog`` containers are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np

from ndtpso_slam_tpu_torch.io.synthetic import ScanLog


def load_log(path: str) -> ScanLog:
    """Load a ``.npz`` scan log (keys ranges, timestamps, angle_min,
    angle_increment, range_max; optional poses, odoms)."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz scan logs are ported yet (ROADMAP A10: .bag, "
            ".csv and .ndtlog readers)"
        )
    with np.load(path) as d:
        return ScanLog(
            ranges=d["ranges"], poses=d.get("poses"), odoms=d.get("odoms"),
            timestamps=d["timestamps"], angle_min=float(d["angle_min"]),
            angle_increment=float(d["angle_increment"]),
            range_max=float(d["range_max"]),
        )
