"""Scan-log loading, and the plain-text scan-log format.

Port of ``ndtpso_slam_tpu/io/importers.py``.  :func:`load_log` reads every
container the JAX package reads, chosen by extension: ``.bag`` (ROS1, through
``io/rosbag.py``), ``.csv`` (the format below), ``.npz`` and the native
runtime's binary ``.ndtlog``.  The JAX package reads ``.ndtlog`` through its
C++ runtime (``native/runtime/runtime.cpp``); here :func:`read_ndtlog` reads
the same bytes with numpy.

CSV format (``# ndtpso-scan-csv v1``)::

    # ndtpso-scan-csv v1
    # angle_min=<float> angle_increment=<float> range_max=<float>
    # columns: timestamp[,odom_x,odom_y,odom_yaw],r0,r1,...
    <ts>,<r0>,<r1>,...

Odometry columns are optional and detected from the header comment.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ndtpso_slam_tpu_torch.io.synthetic import ScanLog

_MAGIC = "# ndtpso-scan-csv v1"

# The native runtime's scan-log header (runtime.cpp:LogHeader): an 8-byte
# magic, the scan and beam counts, then the scan metadata; no padding.
NDTLOG_MAGIC = b"NDTLOG1\0"
_NDTLOG_HEADER = np.dtype([("magic", "S8"), ("t", "<i8"), ("b", "<i8"),
                           ("angle_min", "<f8"), ("angle_increment", "<f8"),
                           ("range_max", "<f8")])


def write_scan_csv(
    path: str,
    ranges: np.ndarray,  # [T, N]
    timestamps: np.ndarray,  # [T]
    angle_min: float,
    angle_increment: float,
    range_max: float,
    odoms: Optional[np.ndarray] = None,  # [T, 3]
) -> None:
    with open(path, "w") as f:
        f.write(_MAGIC + "\n")
        f.write(
            f"# angle_min={angle_min!r} angle_increment={angle_increment!r} "
            f"range_max={range_max!r}\n"
        )
        cols = "timestamp"
        if odoms is not None:
            cols += ",odom_x,odom_y,odom_yaw"
        f.write(f"# columns: {cols},r0,r1,...\n")
        for i in range(ranges.shape[0]):
            row = [repr(float(timestamps[i]))]
            if odoms is not None:
                row += [repr(float(v)) for v in odoms[i]]
            row += [f"{float(r):.6g}" for r in ranges[i]]
            f.write(",".join(row) + "\n")


def read_scan_csv(path: str) -> ScanLog:
    with open(path) as f:
        first = f.readline().strip()
        if first != _MAGIC:
            raise IOError(f"{path}: not a {_MAGIC!r} file")
        meta = {}
        has_odom = False
        pos = f.tell()
        line = f.readline()
        while line.startswith("#"):
            if "angle_min=" in line:
                for part in line[1:].split():
                    if "=" in part:
                        k, v = part.split("=", 1)
                        meta[k] = float(v)
            if "columns:" in line:
                has_odom = "odom_x" in line
            pos = f.tell()
            line = f.readline()
        f.seek(pos)
        data = np.loadtxt(f, delimiter=",", ndmin=2)
    for key in ("angle_min", "angle_increment", "range_max"):
        if key not in meta:
            raise IOError(f"{path}: missing header field {key}")
    ts = data[:, 0]
    if has_odom:
        od = data[:, 1:4]
        ranges = data[:, 4:].astype(np.float32)
    else:
        od = np.zeros((data.shape[0], 3))
        ranges = data[:, 1:].astype(np.float32)
    return ScanLog(
        ranges=ranges, poses=od.copy(), odoms=od, timestamps=ts,
        angle_min=meta["angle_min"], angle_increment=meta["angle_increment"],
        range_max=meta["range_max"],
    )


def read_ndtlog(path: str) -> ScanLog:
    """A native ``.ndtlog`` (``runtime_scanlog_write``, runtime.cpp:223): the
    header, then ranges f32 [T, B], poses f64 [T, 3], odometry f64 [T, 3]
    and timestamps f64 [T].  Raises IOError on a bad magic or a short file,
    where the runtime's reader returns -2 or -3 (runtime.cpp:248)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _NDTLOG_HEADER.itemsize:
        raise IOError(f"{path}: not an .ndtlog scan log (short header)")
    h = np.frombuffer(blob, _NDTLOG_HEADER, count=1)[0]
    if blob[:8] != NDTLOG_MAGIC:
        raise IOError(f"{path}: not an .ndtlog scan log (bad magic)")
    t, b = int(h["t"]), int(h["b"])
    parts = (("ranges", "<f4", (t, b)), ("poses", "<f8", (t, 3)), ("odoms", "<f8", (t, 3)),
             ("timestamps", "<f8", (t,)))
    need = _NDTLOG_HEADER.itemsize + sum(np.dtype(d).itemsize * int(np.prod(s))
                                         for _, d, s in parts)
    if t < 0 or b < 0 or len(blob) < need:
        raise IOError(f"{path}: truncated .ndtlog ({len(blob)} of {need} bytes)")
    out, off = {}, _NDTLOG_HEADER.itemsize
    for name, dtype, shape in parts:
        n = int(np.prod(shape))
        # A native-order copy: the buffer is read-only.
        out[name] = np.frombuffer(blob, dtype, count=n, offset=off).reshape(shape).astype(
            dtype[1:])
        off += n * np.dtype(dtype).itemsize
    return ScanLog(angle_min=float(h["angle_min"]),
                   angle_increment=float(h["angle_increment"]),
                   range_max=float(h["range_max"]), **out)


def load_log(path: str) -> ScanLog:
    """Load a scan log of any supported container by extension: ``.bag``
    (ROS1), ``.csv``, ``.npz``, else the native runtime's ``.ndtlog``."""
    if path.endswith(".bag"):
        from ndtpso_slam_tpu_torch.io.rosbag import read_bag

        return read_bag(path)
    if path.endswith(".csv"):
        return read_scan_csv(path)
    if path.endswith(".npz"):
        with np.load(path) as d:
            return ScanLog(
                ranges=d["ranges"], poses=d.get("poses"), odoms=d.get("odoms"),
                timestamps=d["timestamps"], angle_min=float(d["angle_min"]),
                angle_increment=float(d["angle_increment"]),
                range_max=float(d["range_max"]),
            )
    return read_ndtlog(path)
