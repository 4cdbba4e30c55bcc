"""Map/trajectory export: the `NDTFrame::dumpMap` capability set.

Port of ``ndtpso_slam_tpu/utils/export.py`` (`ndtframe.cpp:268-422`):
``<name>.pose.csv``, ``<name>.map.csv``, ``<name>.gnuplot``, a rendered map
image (grid + points + pose path, OpenCV upstream), the cropped
occupancy-grid PNG, and the engine's ``<name>.cells.csv`` (mean/covariance
per built cell).  File-name patterns (including the parameter-stamped image
names) follow `ndtframe.cpp:392,415`.  The JAX package writes these through
its C++ runtime (``native/runtime/runtime.cpp``); here they are written in
Python with the runtime's formats, and PNG as the runtime writes it (8-bit
gray or RGB, filter 0 on every row, one zlib stream at level 6) with numpy
and ``zlib``, so no image library is needed.

The engine stores no raw per-cell points (their second moments replace
them), so the exported "map points" are the host-side point cloud the node
keeps (`GlobalMap`), the role of the reference's export-only
``global_map_`` frame (`ndtpso_slam_node.cpp:73-74`).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from ndtpso_slam_tpu_torch.config import MapConfig, OccupancyGridConfig, PSOConfig

_PNG_SIGNATURE = bytes([137, 80, 78, 71, 13, 10, 26, 10])


def write_pose_csv(path: str, timestamps, poses, odoms) -> None:
    """``<name>.pose.csv``: the reference's 7-column header
    (`ndtframe.cpp:282`), then timestamp, pose and odometry per row
    (``runtime_write_pose_csv``)."""
    poses = np.asarray(poses, np.float64).reshape(-1, 3)
    odoms = np.asarray(odoms, np.float64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("timestamp,xP,yP,thP,xO,yO,thO\n")
        for t, p, o in zip(timestamps, poses, odoms):
            f.write(f"{float(t):.6f},{p[0]:.5f},{p[1]:.5f},{p[2]:.5f},"
                    f"{o[0]:.5f},{o[1]:.5f},{o[2]:.5f}\n")


def write_map_csv(path: str, points) -> None:
    """``<name>.map.csv`` (`ndtframe.cpp:285-327`, ``runtime_write_map_csv``)."""
    points = np.asarray(points, np.float64).reshape(-1, 2)
    with open(path, "w") as f:
        f.write("x,y\n")
        f.writelines(f"{x:.5f},{y:.5f}\n" for x, y in points)


def write_gnuplot(path: str, basename: str, save_points=True, save_poses=True) -> None:
    """``<name>.gnuplot`` plot script (`ndtframe.cpp:356-388`,
    ``runtime_write_gnuplot``)."""
    with open(path, "w") as f:
        f.write("set datafile separator ','\nset key autotitle columnhead\n"
                "set size ratio -1\nplot ")
        if save_points:
            f.write(f"'{basename}.map.csv' title 'Map' with points pointsize 0.2 "
                    "pointtype 5 linecolor rgb '#555555'")
        if save_poses:
            sep = ", \\\n" if save_points else ""
            f.write(f"{sep}'{basename}.pose.csv' using 2:3 title 'Pose (LiDAR)' with "
                    "linespoints linewidth 0.7 pointtype 6 pointsize 0.7 linecolor rgb "
                    "'#ff0000'")
        f.write("\npause 1000\n")


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray) -> None:
    """pixels: [H, W] grayscale or [H, W, 3] RGB uint8, as an 8-bit PNG."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if pixels.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Pixels of an 8-bit, non-interlaced gray or RGB PNG whose rows use
    filter 0 (what :func:`write_png` and the native runtime write)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise IOError(f"{path}: not a PNG file")
    off, idat, hdr = 8, b"", None
    while off < len(blob):
        (n,) = struct.unpack(">I", blob[off:off + 4])
        kind, data = blob[off + 4:off + 8], blob[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (0, 2) or interlace:
        raise IOError(f"{path}: only 8-bit gray/RGB non-interlaced PNGs are read")
    ch = 1 if color == 0 else 3
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise IOError(f"{path}: a row uses a PNG filter other than 0")
    return rows[:, 1:].reshape((h, w) if ch == 1 else (h, w, 3))


class GlobalMap:
    """Host-side export-only point/pose container (the reference's
    ``global_map_`` NDTFrame-with-one-cell, `ndtpso_slam_node.cpp:73-74`)."""

    def __init__(self, keep_every: int = 10):
        # SAVE_DATA_TO_FILE_EACH_NUM_ITERS = 10 (`ndtpso_slam_node.hpp:18`)
        self.keep_every = keep_every
        self._points = []
        self._poses = []
        self._odoms = []
        self._timestamps = []
        self._n_scans = 0

    def add_scan(self, points, valid, pose: np.ndarray):
        """Store a scan's world-frame points every ``keep_every`` scans
        (`ndtpso_slam_node.cpp:200-205`).  points [N, 2] and valid [N] are
        numpy arrays or tensors, copied to the host only on the scans kept."""
        if self._n_scans % self.keep_every == 0:
            host = lambda a: a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
            c, s = np.cos(pose[2]), np.sin(pose[2])
            p = host(points).astype(np.float64)[host(valid).astype(bool)]
            world = np.stack(
                [
                    p[:, 0] * c - p[:, 1] * s + pose[0],
                    p[:, 0] * s + p[:, 1] * c + pose[1],
                ],
                axis=-1,
            )
            self._points.append(world)
        self._n_scans += 1

    def add_pose(self, timestamp: float, pose, odom=None):
        """`NDTFrame::addPose` (`ndtframe.cpp:200-206`), every scan."""
        self._timestamps.append(float(timestamp))
        self._poses.append(np.asarray(pose, np.float64))
        self._odoms.append(
            np.asarray(odom, np.float64) if odom is not None else np.zeros(3)
        )

    @property
    def points(self) -> np.ndarray:
        return (
            np.concatenate(self._points) if self._points else np.zeros((0, 2))
        )

    @property
    def poses(self) -> np.ndarray:
        return np.array(self._poses).reshape(-1, 3)

    @property
    def odoms(self) -> np.ndarray:
        return np.array(self._odoms).reshape(-1, 3)

    @property
    def timestamps(self) -> np.ndarray:
        return np.array(self._timestamps)


def render_map_image(
    points: np.ndarray,
    poses: np.ndarray,
    size_m: float,
    density: int = 100,
) -> np.ndarray:
    """Rasterize the reference's map image (`ndtframe.cpp:297-348`): white
    canvas, 1 m gray grid, black map points, red pose dots with a heading
    tick on every 5th pose.  Returns [H, W, 3] uint8 (y up -> row down)."""
    size = int(size_m * density)
    img = np.full((size, size, 3), 255, np.uint8)
    # Grid lines each meter (gray 180)
    for i in range(0, size, density):
        img[i, :] = 180
        img[:, i] = 180

    def to_px(xy):
        x = (size // 2) + (xy[:, 0] * density).astype(int)
        y = (size // 2) - (xy[:, 1] * density).astype(int)
        ok = (x >= 0) & (x < size) & (y >= 0) & (y < size)
        return x[ok], y[ok]

    if len(points):
        x, y = to_px(np.asarray(points))
        img[y, x] = 0
    if len(poses):
        poses = np.asarray(poses)
        for k, p in enumerate(poses):
            x = (size // 2) + int(p[0] * density)
            y = (size // 2) - int(p[1] * density)
            if not (0 <= x < size and 0 <= y < size):
                continue
            if k % 5 == 0:  # heading tick (`ndtframe.cpp:334-339`)
                dx = 0.5 * np.cos(p[2])
                dy = 0.5 * np.sin(p[2])
                n = max(int(density * 0.5), 1)
                for t in np.linspace(0, 1, n):
                    xx = x + int(t * dx * density)
                    yy = y - int(t * dy * density)
                    if 0 <= xx < size and 0 <= yy < size:
                        img[yy, xx] = (80, 40, 40)
            y0, y1 = max(y - 1, 0), min(y + 2, size)
            x0, x1 = max(x - 1, 0), min(x + 2, size)
            img[y0:y1, x0:x1] = (255, 0, 0)
    return img


def render_og_image(og: np.ndarray, bbox) -> Optional[np.ndarray]:
    """Cropped occupancy-grid raster as grayscale (`ndtframe.cpp:398-419`):
    255 - og*2.55 where occupied, white elsewhere, y flipped."""
    min_x, max_x, min_y, max_y = (int(v) for v in bbox)
    if max_x < min_x or max_y < min_y:
        return None
    crop = np.asarray(og)[min_y : max_y + 1, min_x : max_x + 1]
    img = np.full(crop.shape, 255, np.uint8)
    occ = crop > 0
    img[occ] = (255.0 - crop[occ] * 2.55).astype(np.uint8)
    return img[::-1]  # y up


def dump_map(
    basename: str,
    global_map: Optional[GlobalMap] = None,
    save_poses: bool = True,
    save_points: bool = True,
    save_image: bool = False,
    density: int = 100,
    map_cfg: Optional[MapConfig] = None,
    pso_cfg: Optional[PSOConfig] = None,
    og: Optional[np.ndarray] = None,
    og_bbox=None,
    og_cfg: Optional[OccupancyGridConfig] = None,
    map_state=None,
) -> list:
    """Write the export bundle; returns the list of files written."""
    written = []
    points = global_map.points if global_map else np.zeros((0, 2))
    poses = global_map.poses if global_map else np.zeros((0, 3))
    if save_poses and global_map is not None:
        path = f"{basename}.pose.csv"
        write_pose_csv(path, global_map.timestamps, poses, global_map.odoms)
        written.append(path)
    if save_points:
        path = f"{basename}.map.csv"
        write_map_csv(path, points)
        written.append(path)
    if save_poses or save_points:
        path = f"{basename}.gnuplot"
        write_gnuplot(path, os.path.basename(basename), save_points, save_poses)
        written.append(path)
    if save_image and map_cfg is not None:
        w = int(map_cfg.size_m)
        pop = pso_cfg.population if pso_cfg else 0
        iters = pso_cfg.iterations if pso_cfg else 0
        path = (
            f"{basename}-w{map_cfg.window_slots}-{pop}p{iters}i-"
            f"{w}x{w}-c{map_cfg.cell_side_m:.2f}-{density}ppm.png"
        )
        write_png(path, render_map_image(points, poses, map_cfg.size_m, density))
        written.append(path)
    if og is not None and og_bbox is not None and og_cfg is not None and map_cfg is not None:
        img = render_og_image(og, og_bbox)
        if img is not None:
            h, w_ = np.asarray(og).shape
            path = (
                f"{basename}-{w_}x{h}-cell{og_cfg.cell_size_m:.2f}m-"
                f"occupancy-grid.png"
            )
            write_png(path, img)
            written.append(path)
    if map_state is not None and map_cfg is not None:
        written.append(export_cells_csv(f"{basename}.cells.csv", map_state, map_cfg))
    return written


def export_cells_csv(path: str, map_state, map_cfg: MapConfig) -> str:
    """Per-built-cell Gaussian summary (engine-only capability)."""
    from ndtpso_slam_tpu_torch.models import ndt_map

    snap = ndt_map.snapshot(map_state, map_cfg)
    built = snap.built.cpu().numpy()
    mean = snap.mean.cpu().numpy()[built]
    icov = snap.inv_cov.cpu().numpy()[built]
    count = map_state.g_count[:map_cfg.num_cells].cpu().numpy()[built]
    with open(path, "w") as f:
        f.write("mean_x,mean_y,icov_xx,icov_xy,icov_yy,count\n")
        for m, ic, n in zip(mean, icov, count):
            f.write(
                f"{m[0]:.5f},{m[1]:.5f},{ic[0]:.6g},{ic[1]:.6g},{ic[2]:.6g},{int(n)}\n"
            )
    return path
