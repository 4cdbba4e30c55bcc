"""The SLAM node: a streaming session and its CLI.

Port of the single-session part of ``ndtpso_slam_tpu/node.py``
(``NDTPSONode``, ``src/ndtpso_slam_node.cpp``): scans come from a scan log
(``.npz``) or any caller, poses go to registered callbacks, and the run's
poses are written as ``<out>.pose.csv``.  ``build_og`` (``--og``) keeps the
occupancy raster in ``node.state.og``; ``recovery`` (``--recovery``) turns on
tracking-loss detection and relocalization (``models/slam.py``).  Options the
port cannot run yet (sparse ring, GLIR, frontal-point decimation, the stencil
patch) raise NotImplementedError naming their ROADMAP item.  Every
cost mode of the JAX package runs (``models/slam.py:SLAM_COST_MODES``).

Run over a log on the GPU::

    python -m ndtpso_slam_tpu_torch.node --scanlog run.npz --out run \\
        --cost-mode rollout_local --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from ndtpso_slam_tpu_torch import config as cfgm
from ndtpso_slam_tpu_torch.models import scan as scan_mod
from ndtpso_slam_tpu_torch.models import slam
from ndtpso_slam_tpu_torch.ops import rng
from ndtpso_slam_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """Node-level parameters (``ndtpso_slam_node.hpp:24-34``, scan.launch);
    the JAX package's fields and defaults."""

    frame_size_m: float = 300.0
    cell_side_m: float = 0.5
    map_size_m: float = 25.0  # export-only global map extent
    rate_hz: int = 10
    og_cell_size_m: float = 0.1
    build_og: bool = False
    init_pose: tuple = (0.0, 0.0, 0.0)
    mount_trans: tuple = (0.0, 0.0, 0.0)  # latched base<-scan transform
    pso_iterations: int = 30
    pso_population: int = 50
    pso_w: float = cfgm.PSO_W
    pso_c1: float = cfgm.PSO_C1
    pso_c2: float = cfgm.PSO_C2
    pso_w_damping: float = cfgm.PSO_W_DAMPING
    window_slots: int = cfgm.NDT_WINDOW_SIZE
    max_beams: int = 1024
    # local_exact: per-particle stencil rebind; rollout_local runs the same
    # solve as one CUDA kernel launch (models/slam.py:SLAM_COST_MODES).
    cost_mode: str = "local_exact"
    optimizer: str = "pso"
    seed: int = 42
    save_every: int = 10
    save_map_images: bool = False
    recovery: bool = False
    recovery_fitness_threshold: float = 0.15
    recovery_hypotheses: int = 8
    patch_range_m: float = 0.0
    ring_rows: int = 0
    prefer_frontal_points: bool = False

    def slam_config(self) -> cfgm.SlamConfig:
        map_cfg = cfgm.MapConfig(
            size_m=self.frame_size_m,
            cell_side_m=self.cell_side_m,
            window_slots=self.window_slots,
            ring_rows=self.ring_rows,
        )
        if self.patch_range_m > 0:
            map_cfg = dataclasses.replace(
                map_cfg,
                stencil_patch_cells=map_cfg.patch_cells_for_range(self.patch_range_m),
            )
        return cfgm.SlamConfig(
            pso=cfgm.PSOConfig(
                iterations=self.pso_iterations,
                population=self.pso_population,
                w=self.pso_w,
                c1=self.pso_c1,
                c2=self.pso_c2,
                w_damping=self.pso_w_damping,
            ),
            map=map_cfg,
            scan=cfgm.ScanConfig(
                max_beams=self.max_beams,
                prefer_frontal_points=self.prefer_frontal_points,
            ),
            og=cfgm.OccupancyGridConfig(
                cell_size_m=self.og_cell_size_m, enabled=self.build_og
            ),
            recovery=cfgm.RecoveryConfig(
                enabled=self.recovery,
                fitness_threshold=self.recovery_fitness_threshold,
                k_hypotheses=self.recovery_hypotheses,
            ),
            cost_mode=self.cost_mode,
            optimizer=self.optimizer,
        )

    def check_supported(self) -> None:
        """Raise NotImplementedError for options the port cannot run yet."""
        if self.prefer_frontal_points:
            raise NotImplementedError(
                "prefer_frontal_points in the node is not ported yet (ROADMAP A4)"
            )
        if self.patch_range_m > 0:
            raise NotImplementedError(
                "patch_range_m (the stencil patch) is not ported yet (ROADMAP A6)"
            )
        slam.check_supported(self.slam_config())

    @staticmethod
    def from_json(path: str, **overrides) -> "NodeConfig":
        with open(path) as f:
            data = json.load(f)
        data.update({k: v for k, v in overrides.items() if v is not None})
        fields = {f.name for f in dataclasses.fields(NodeConfig)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        for key in ("init_pose", "mount_trans"):
            if key in data:
                data[key] = tuple(data[key])
        return NodeConfig(**data)


def write_pose_csv(path: str, timestamps, poses, odoms=None) -> None:
    """``<name>.pose.csv`` in the format of the native runtime's
    ``runtime_write_pose_csv``: a header, then timestamp, pose and (when
    known) odometry per row."""
    poses = np.asarray(poses, np.float64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("timestamp,xP,yP,thP,xO,yO,thO\n")
        for i, p in enumerate(poses):
            f.write(f"{float(timestamps[i]):.6f},{p[0]:.5f},{p[1]:.5f},{p[2]:.5f}")
            if odoms is None:
                f.write(",,,\n")
            else:
                o = np.asarray(odoms[i], np.float64)
                f.write(f",{o[0]:.5f},{o[1]:.5f},{o[2]:.5f}\n")


class SlamNode:
    """Streaming SLAM session: feed scans, get poses."""

    def __init__(self, node_cfg: NodeConfig, verbose: bool = True, device="cuda"):
        node_cfg.check_supported()
        self.cfg = node_cfg
        self.slam_cfg = node_cfg.slam_config()
        self.device = cfgm.resolve_device(device)
        self.state = slam.init_slam(self.slam_cfg, node_cfg.init_pose, self.device)
        self.meter = profiling.RateMeter()
        self.pose_callbacks: List[Callable] = []
        self.verbose = verbose
        self._key = (node_cfg.seed & 0xFFFFFFFF, (node_cfg.seed ^ 0x9E3779B9) & 0xFFFFFFFF)
        self._mount = (
            np.asarray(node_cfg.mount_trans, np.float32)
            if any(abs(v) > 1e-9 for v in node_cfg.mount_trans)
            else None
        )
        self.timestamps: List[float] = []
        self.poses: List[np.ndarray] = []
        self.odoms: List[Optional[np.ndarray]] = []

    def on_pose(self, callback: Callable) -> None:
        """Register a pose 'publisher' (timestamp, pose[3]) -> None."""
        self.pose_callbacks.append(callback)

    def process_scan(
        self,
        ranges: np.ndarray,
        angle_min: float,
        angle_increment: float,
        range_max: float,
        timestamp: float = 0.0,
        odom=None,
    ) -> np.ndarray:
        """One scan callback (``scan_matcher_``, ``ndtpso_slam_node.cpp:177-244``).
        Returns the estimated [3] pose."""
        with self.meter.tick():
            sc = scan_mod.load_laser(
                np.asarray(ranges, np.float32), angle_min, angle_increment, range_max,
                self.slam_cfg.scan, self.slam_cfg.map, mount=self._mount,
                device=self.device,
            )
            # Key from the state's step counter, so a restored state resumes
            # the same random stream.
            key = rng.derive_key(self._key, self.state.step)
            self.state, pose, _cost = slam.slam_step(self.state, sc, key, self.slam_cfg)
            pose_np = pose.cpu().numpy().astype(np.float64)
        self.timestamps.append(float(timestamp))
        self.poses.append(pose_np)
        self.odoms.append(None if odom is None else np.asarray(odom, np.float64))
        for cb in self.pose_callbacks:
            cb(timestamp, pose_np)
        if self.verbose and self.state.step > 1:
            extra = ""
            if self.slam_cfg.recovery.enabled:
                extra = (f", fitness {float(self.state.fitness):.3f}"
                         f", recoveries {self.state.recoveries}")
            print(
                f"[ndtpso] scan {self.state.step}: pose "
                f"({pose_np[0]:.3f}, {pose_np[1]:.3f}, {pose_np[2]:.3f}){extra} | "
                f"avg rate {self.meter.average_rate_hz:.2f} Hz, "
                f"matching rate {self.meter.matching_rate_hz:.2f} Hz",
                file=sys.stderr,
            )
        return pose_np

    def run_log(self, log) -> np.ndarray:
        """Process a whole ScanLog; returns [T, 3] poses."""
        poses = []
        for i in range(len(log.ranges)):
            odom = log.odoms[i] if log.odoms is not None else None
            poses.append(
                self.process_scan(
                    log.ranges[i], log.angle_min, log.angle_increment,
                    log.range_max, timestamp=float(log.timestamps[i]), odom=odom,
                )
            )
        return np.array(poses)

    def shutdown(self, basename: Optional[str] = None) -> List[str]:
        """Write ``<basename>.pose.csv``; returns the files written.  The rest
        of the JAX package's export bundle (map CSV, gnuplot, images) is not
        ported yet (ROADMAP A10)."""
        if basename is None:
            basename = "ndtpso-" + time.strftime("%Y%m%d-%H%M%S")
        path = f"{basename}.pose.csv"
        odoms = None if any(o is None for o in self.odoms) else self.odoms
        write_pose_csv(path, self.timestamps, self.poses, odoms)
        return [path]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ndtpso SLAM node (PyTorch port): run SLAM over a recorded scan log"
    )
    ap.add_argument("--scanlog", required=True, help=".npz scan log")
    ap.add_argument("--config", help="launch JSON (see launch/)")
    ap.add_argument("--out", default=None, help="output basename: writes <out>.pose.csv")
    ap.add_argument("--cost-mode", choices=list(slam.SLAM_COST_MODES), default=None)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--population", type=int, default=None)
    ap.add_argument("--frame-size", type=float, default=None)
    ap.add_argument("--cell-side", type=float, default=None)
    ap.add_argument("--max-beams", type=int, default=None,
                    help="padded beam count (static shape)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--og", action="store_true", help="build the occupancy grid")
    ap.add_argument("--recovery", action="store_true",
                    help="enable tracking-loss detection + multi-swarm relocalization")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=cfgm.DEFAULT_DEVICE,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)

    overrides = dict(
        cost_mode=args.cost_mode,
        pso_iterations=args.iterations,
        pso_population=args.population,
        frame_size_m=args.frame_size,
        cell_side_m=args.cell_side,
        max_beams=args.max_beams,
        seed=args.seed,
    )
    if args.og:
        overrides["build_og"] = True
    if args.recovery:
        overrides["recovery"] = True
    if args.config:
        node_cfg = NodeConfig.from_json(args.config, **overrides)
    else:
        node_cfg = dataclasses.replace(
            NodeConfig(), **{k: v for k, v in overrides.items() if v is not None}
        )

    from ndtpso_slam_tpu_torch.io.importers import load_log

    log = load_log(args.scanlog)
    node = SlamNode(node_cfg, verbose=not args.quiet, device=args.device)
    t0 = time.time()
    poses = node.run_log(log)
    dt = time.time() - t0
    print(
        f"[ndtpso] processed {len(poses)} scans in {dt:.2f}s ({len(poses) / dt:.2f} Hz)",
        file=sys.stderr,
    )
    for f in node.shutdown(args.out):
        print(f"[ndtpso] wrote {f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
