"""Pure-Python ROS1 bag (v2.0) reader/writer for 2D LiDAR logs.

A copy of ``ndtpso_slam_tpu/io/rosbag.py`` (numpy and ``struct`` only), kept
in the port so that it never imports the JAX package.

The reference consumes live `sensor_msgs/LaserScan` messages over roscpp
(`src/ndtpso_slam_node.cpp:118,177-244`); its recorded-data
workflow is rosbag-based (README "you can use the `rosbag` command").  This
module is the ingestion bridge: it converts recorded `.bag` files into the
engine's `ScanLog` (and can write bags back out for the ROS ecosystem),
with zero ROS dependencies — a clean-room implementation of the public bag
v2.0 container format (http://wiki.ros.org/Bags/Format/2.0) and of the
`sensor_msgs/LaserScan` / `nav_msgs/Odometry` wire serializations.

Supported: uncompressed and bz2 chunks (lz4 if the `lz4` package exists —
it is not required).  Written bags put all messages in one uncompressed
chunk and carry no index records (`rosbag reindex` rebuilds one in-place if
ROS tooling needs it); our reader scans linearly and needs no index.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSGDATA = 0x02
OP_BAGHEADER = 0x03
OP_INDEXDATA = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONNECTION = 0x07

LASERSCAN_TYPE = "sensor_msgs/LaserScan"
LASERSCAN_MD5 = "90c7ef2dc6895d81024acba2ac42f369"
ODOMETRY_TYPE = "nav_msgs/Odometry"
ODOMETRY_MD5 = "cd5e73d190d741a2f92e81eda573aca7"

# Message definitions are required fields of connection records; ROS tools
# only need them for introspection, so the concise canonical text suffices.
LASERSCAN_DEF = """\
std_msgs/Header header
float32 angle_min
float32 angle_max
float32 angle_increment
float32 time_increment
float32 scan_time
float32 range_min
float32 range_max
float32[] ranges
float32[] intensities
"""
ODOMETRY_DEF = """\
std_msgs/Header header
string child_frame_id
geometry_msgs/PoseWithCovariance pose
geometry_msgs/TwistWithCovariance twist
"""


# --------------------------------------------------------------------------
# low-level container encoding


def _encode_header(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        entry = name.encode() + b"=" + value
        out += struct.pack("<I", len(entry)) + entry
    return out


def _decode_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        entry = buf[off:off + flen]
        off += flen
        name, _, value = entry.partition(b"=")
        fields[name.decode()] = value
    return fields


def _read_record(buf: bytes, off: int) -> Tuple[Dict[str, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    header = _decode_header(buf[off:off + hlen])
    off += hlen
    (dlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    data = buf[off:off + dlen]
    off += dlen
    return header, data, off


def _write_record(fields: Dict[str, bytes], data: bytes) -> bytes:
    header = _encode_header(fields)
    return (
        struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data
    )


def _decompress(compression: str, data: bytes, size: int) -> bytes:
    if compression == "none":
        return data
    if compression == "bz2":
        import bz2

        return bz2.decompress(data)
    if compression == "lz4":
        try:
            import lz4.frame  # type: ignore
        except ImportError as e:
            raise IOError(
                "bag uses lz4 chunk compression and the Python module 'lz4' "
                "(lz4.frame) is not installed; re-record with --bz2 or no "
                "compression"
            ) from e
        return lz4.frame.decompress(data)
    raise IOError(f"unknown chunk compression {compression!r}")


def _iter_messages(path: str) -> Iterator[Tuple[Dict, int, bytes]]:
    """Yield (connection_info, time_ns, raw_message_bytes) linearly.

    connection_info: {'topic': str, 'type': str}.  Index records are
    ignored; both in-chunk and top-level connection/message records are
    handled.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise IOError(f"{path} is not a ROS bag v2.0 file")
    conns: Dict[int, Dict] = {}
    pending: List[Tuple[int, int, bytes]] = []

    def handle(header: Dict[str, bytes], data: bytes):
        op = header["op"][0]
        if op == OP_CONNECTION:
            (cid,) = struct.unpack("<I", header["conn"])
            sub = _decode_header(data)
            conns[cid] = {
                "topic": sub.get("topic", header.get("topic", b"")).decode(),
                "type": sub.get("type", b"").decode(),
            }
        elif op == OP_MSGDATA:
            (cid,) = struct.unpack("<I", header["conn"])
            secs, nsecs = struct.unpack("<II", header["time"])
            pending.append((cid, secs * 10**9 + nsecs, data))

    off = len(MAGIC)
    while off < len(blob):
        header, data, off = _read_record(blob, off)
        op = header["op"][0]
        if op == OP_CHUNK:
            comp = header["compression"].decode()
            (usize,) = struct.unpack("<I", header["size"])
            chunk = _decompress(comp, data, usize)
            coff = 0
            while coff < len(chunk):
                ch, cd, coff = _read_record(chunk, coff)
                handle(ch, cd)
        else:
            handle(header, data)
    for cid, t, raw in pending:
        if cid in conns:
            yield conns[cid], t, raw


# --------------------------------------------------------------------------
# message (de)serialization


def _read_ros_header(raw: bytes, off: int) -> Tuple[int, int, str, int]:
    seq, secs, nsecs, slen = struct.unpack_from("<IIII", raw, off)
    off += 16
    frame_id = raw[off:off + slen].decode(errors="replace")
    return secs, nsecs, frame_id, off + slen


def parse_laserscan(raw: bytes):
    """-> (stamp_s, angle_min, angle_max, angle_increment, range_min,
    range_max, ranges f32[N])."""
    secs, nsecs, _frame, off = _read_ros_header(raw, 0)
    amin, amax, ainc, _tinc, _stime, rmin, rmax = struct.unpack_from(
        "<7f", raw, off
    )
    off += 28
    (n,) = struct.unpack_from("<I", raw, off)
    off += 4
    ranges = np.frombuffer(raw, dtype="<f4", count=n, offset=off).copy()
    return secs + nsecs * 1e-9, amin, amax, ainc, rmin, rmax, ranges


def parse_odometry(raw: bytes):
    """-> (stamp_s, x, y, yaw)."""
    secs, nsecs, _frame, off = _read_ros_header(raw, 0)
    (clen,) = struct.unpack_from("<I", raw, off)
    off += 4 + clen  # child_frame_id
    x, y, _z, qx, qy, qz, qw = struct.unpack_from("<7d", raw, off)
    yaw = float(np.arctan2(2.0 * (qw * qz + qx * qy),
                           1.0 - 2.0 * (qy * qy + qz * qz)))
    return secs + nsecs * 1e-9, x, y, yaw


def _ros_header_bytes(seq: int, stamp_s: float, frame_id: str) -> bytes:
    secs = int(stamp_s)
    nsecs = int(round((stamp_s - secs) * 1e9))
    fid = frame_id.encode()
    return struct.pack("<IIII", seq, secs, nsecs, len(fid)) + fid


def serialize_laserscan(
    seq: int, stamp_s: float, frame_id: str, angle_min: float,
    angle_increment: float, range_max: float, ranges: np.ndarray,
    range_min: float = 0.0, scan_time: float = 0.1,
) -> bytes:
    r = np.ascontiguousarray(ranges, "<f4")
    n = r.shape[0]
    angle_max = angle_min + angle_increment * (n - 1)
    return (
        _ros_header_bytes(seq, stamp_s, frame_id)
        + struct.pack(
            "<7f", angle_min, angle_max, angle_increment,
            scan_time / max(n, 1), scan_time, range_min, range_max,
        )
        + struct.pack("<I", n) + r.tobytes()
        + struct.pack("<I", 0)  # intensities: empty
    )


def serialize_odometry(
    seq: int, stamp_s: float, frame_id: str, x: float, y: float, yaw: float
) -> bytes:
    half = yaw / 2.0
    pose = struct.pack(
        "<7d", x, y, 0.0, 0.0, 0.0, float(np.sin(half)), float(np.cos(half))
    ) + b"\x00" * (36 * 8)
    twist = struct.pack("<6d", 0, 0, 0, 0, 0, 0) + b"\x00" * (36 * 8)
    child = b"base_link"
    return (
        _ros_header_bytes(seq, stamp_s, frame_id)
        + struct.pack("<I", len(child)) + child
        + pose + twist
    )


# --------------------------------------------------------------------------
# public API


def read_bag(
    path: str,
    scan_topic: Optional[str] = None,
    odom_topic: Optional[str] = None,
    max_beams: Optional[int] = None,
):
    """Convert a recorded bag into a `ScanLog`.

    Topic selection: explicit topics, else the first LaserScan / Odometry
    connection found.  Odometry poses are matched to each scan by
    latest-at-or-before timestamp (the reference's TF-style association);
    with no odometry in the bag, `odoms` (and `poses`, which are best-effort
    and only used for error overlays) are zero.
    """
    from ndtpso_slam_tpu_torch.io.synthetic import ScanLog

    scans = []  # (t, amin, ainc, rmax, ranges)
    odoms = []  # (t, x, y, yaw)
    for conn, _tns, raw in _iter_messages(path):
        if conn["type"] == LASERSCAN_TYPE and (
            scan_topic is None or conn["topic"] == scan_topic
        ):
            if scan_topic is None:
                scan_topic = conn["topic"]
            t, amin, _amax, ainc, _rmin, rmax, r = parse_laserscan(raw)
            scans.append((t, amin, ainc, rmax, r))
        elif conn["type"] == ODOMETRY_TYPE and (
            odom_topic is None or conn["topic"] == odom_topic
        ):
            if odom_topic is None:
                odom_topic = conn["topic"]
            odoms.append(parse_odometry(raw))
    if not scans:
        raise IOError(
            f"{path}: no {LASERSCAN_TYPE} messages"
            + (f" on topic {scan_topic}" if scan_topic else "")
        )
    scans.sort(key=lambda s: s[0])
    n = max(s[4].shape[0] for s in scans)
    if max_beams is not None and n > max_beams:
        raise ValueError(f"bag scans have {n} beams > max_beams={max_beams}")
    t0 = len(scans)
    ranges = np.zeros((t0, n), np.float32)  # 0 = no return (filtered at load)
    ts = np.zeros(t0)
    for i, (t, _a, _i2, _r, r) in enumerate(scans):
        ranges[i, : r.shape[0]] = r
        ts[i] = t
    amin, ainc, rmax = scans[0][1], scans[0][2], scans[0][3]

    od = np.zeros((t0, 3))
    if odoms:
        odoms.sort(key=lambda o: o[0])
        ot = np.array([o[0] for o in odoms])
        ov = np.array([[o[1], o[2], o[3]] for o in odoms])
        idx = np.clip(np.searchsorted(ot, ts, side="right") - 1, 0, len(ot) - 1)
        od = ov[idx]
    return ScanLog(
        ranges=ranges, poses=od.copy(), odoms=od, timestamps=ts,
        angle_min=float(amin), angle_increment=float(ainc),
        range_max=float(rmax),
    )


def write_bag(
    path: str,
    ranges: np.ndarray,  # [T, N]
    timestamps: np.ndarray,  # [T]
    angle_min: float,
    angle_increment: float,
    range_max: float,
    odoms: Optional[np.ndarray] = None,  # [T, 3] x, y, yaw
    scan_topic: str = "/scan",
    odom_topic: str = "/odom",
    frame_id: str = "laser",
) -> None:
    """Write a (unindexed) v2.0 bag with one LaserScan connection and,
    optionally, one Odometry connection — round-trippable by :func:`read_bag`
    and by ROS tooling after `rosbag reindex`."""
    chunk = b""

    def conn_record(cid: int, topic: str, mtype: str, md5: str, mdef: str):
        sub = _encode_header(
            {
                "topic": topic.encode(),
                "type": mtype.encode(),
                "md5sum": md5.encode(),
                "message_definition": mdef.encode(),
            }
        )
        return _write_record(
            {
                "op": bytes([OP_CONNECTION]),
                "conn": struct.pack("<I", cid),
                "topic": topic.encode(),
            },
            sub,
        )

    chunk += conn_record(0, scan_topic, LASERSCAN_TYPE, LASERSCAN_MD5,
                         LASERSCAN_DEF)
    n_conn = 1
    if odoms is not None:
        chunk += conn_record(1, odom_topic, ODOMETRY_TYPE, ODOMETRY_MD5,
                             ODOMETRY_DEF)
        n_conn = 2

    def msg_record(cid: int, stamp_s: float, raw: bytes) -> bytes:
        secs = int(stamp_s)
        nsecs = int(round((stamp_s - secs) * 1e9))
        return _write_record(
            {
                "op": bytes([OP_MSGDATA]),
                "conn": struct.pack("<I", cid),
                "time": struct.pack("<II", secs, nsecs),
            },
            raw,
        )

    for i in range(ranges.shape[0]):
        t = float(timestamps[i])
        if odoms is not None:
            chunk += msg_record(
                1, t, serialize_odometry(i, t, "odom", *map(float, odoms[i]))
            )
        chunk += msg_record(
            0, t,
            serialize_laserscan(
                i, t, frame_id, angle_min, angle_increment, range_max,
                ranges[i],
            ),
        )

    with open(path, "wb") as f:
        f.write(MAGIC)
        # Bag header record, padded to 4096 bytes total as per the format.
        bh_fields = {
            "op": bytes([OP_BAGHEADER]),
            "index_pos": struct.pack("<Q", 0),  # unindexed
            "conn_count": struct.pack("<I", n_conn),
            "chunk_count": struct.pack("<I", 1),
        }
        bh_header = _encode_header(bh_fields)
        pad = 4096 - 8 - len(bh_header)
        f.write(struct.pack("<I", len(bh_header)) + bh_header)
        f.write(struct.pack("<I", pad) + b" " * pad)
        f.write(
            _write_record(
                {
                    "op": bytes([OP_CHUNK]),
                    "compression": b"none",
                    "size": struct.pack("<I", len(chunk)),
                },
                chunk,
            )
        )
