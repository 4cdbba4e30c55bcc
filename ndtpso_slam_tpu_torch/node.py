"""The SLAM node: a streaming session and its CLI.

Port of the single-session part of ``ndtpso_slam_tpu/node.py``
(``NDTPSONode``, ``src/ndtpso_slam_node.cpp``): scans come from a scan log
(``.bag``, ``.csv``, ``.npz`` or the native ``.ndtlog``, ``io/importers.py``)
or any caller, poses go to registered callbacks, rate metrics are kept like
the reference's per-scan report, and shutdown writes the export bundle
(``utils/export.py``: ``<out>.pose.csv``, ``.map.csv``, ``.gnuplot``,
``.cells.csv``, with ``save_map_images`` the map image and with ``build_og``
the occupancy-grid image).  The session's state can be checkpointed and
resumed (``utils/checkpoint.py``).  Every option of the JAX node's single
session runs: every cost mode (``models/slam.py:SLAM_COST_MODES``), the
GLIR-PSO optimizer on the plain cost modes, the occupancy raster
(``--og``), tracking-loss recovery (``--recovery``), a sparse ring
(``ring_rows``, with a warning when it overflows), the stencil patch
(``patch_range_m``) and frontal-point decimation
(``--prefer-frontal-points``).  :class:`MultiSessionNode` runs several
sessions in one process, the reference's one-node-per-LiDAR deployment
(``launch/lidar_front.launch`` + ``lidar_back.launch``) through
``parallel/sessions.py:SlamSessionPool``: the CLI takes a repeated
``--scanlog`` (and one ``--config`` per log, or one for all).

Run over a log on the GPU::

    python -m ndtpso_slam_tpu_torch.node --scanlog run.bag --out run \\
        --cost-mode rollout_local --checkpoint run-state.npz

and over two sensors' logs as two sessions (bundles ``duo-s0.*``,
``duo-s1.*``)::

    python -m ndtpso_slam_tpu_torch.node --scanlog front.npz --scanlog back.npz \\
        --config launch/lidar_front.json --config launch/lidar_back.json \\
        --cost-mode rollout_local --max-beams 384 --out duo
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
from ndtpso_slam_tpu_torch.models.pso import OPTIMIZERS
from ndtpso_slam_tpu_torch.ops import rng
from ndtpso_slam_tpu_torch.parallel.sessions import SlamSessionPool
from ndtpso_slam_tpu_torch.utils import checkpoint, profiling
from ndtpso_slam_tpu_torch.utils import export as export_mod


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
    # 'pso' (deployed) | 'glir' (GLIR-PSO, core.h:21-23; plain cost modes).
    optimizer: str = "pso"
    seed: int = 42
    save_every: int = 10  # keep every n-th scan's points for the export
    save_map_images: bool = False
    recovery: bool = False
    recovery_fitness_threshold: float = 0.15
    recovery_hypotheses: int = 8
    # > 0: the stencil patch covering a scan of this range (MapConfig.
    # stencil_patch_cells); a neighbour outside it counts as unbuilt.
    patch_range_m: float = 0.0
    # > 0: a sparse ring of this many rows (MapConfig.ring_rows).
    ring_rows: int = 0
    # PREFER_FRONTAL_POINTS beam decimation (config.h:11); off upstream.
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

    @staticmethod
    def from_json(path: str, **overrides) -> "NodeConfig":
        """A config from a launch JSON (see ``launch/``) and overrides; keys
        beginning with ``_`` are comments (the launch files' ``_comment``,
        which the JAX package's reader refuses, ROADMAP R8), any other
        unknown key raises ValueError."""
        with open(path) as f:
            data = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
        data.update({k: v for k, v in overrides.items() if v is not None})
        fields = {f.name for f in dataclasses.fields(NodeConfig)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        for key in ("init_pose", "mount_trans"):
            if key in data:
                data[key] = tuple(data[key])
        return NodeConfig(**data)


def _seed_key(seed: int):
    """A session's base key (k0, k1) from its node seed."""
    return seed & 0xFFFFFFFF, (seed ^ 0x9E3779B9) & 0xFFFFFFFF


def _mount_of(node_cfg: NodeConfig):
    """The latched base<-scan transform [3] to apply at scan load, or None."""
    if any(abs(v) > 1e-9 for v in node_cfg.mount_trans):
        return np.asarray(node_cfg.mount_trans, np.float32)
    return None


class SlamNode:
    """Streaming SLAM session: feed scans, get poses."""

    def __init__(self, node_cfg: NodeConfig, verbose: bool = True, device="cuda"):
        self.cfg = node_cfg
        self.slam_cfg = node_cfg.slam_config()
        slam.validate_config(self.slam_cfg)
        self.device = cfgm.resolve_device(device)
        self.state = slam.init_slam(self.slam_cfg, node_cfg.init_pose, self.device)
        self.global_map = export_mod.GlobalMap(keep_every=node_cfg.save_every)
        self.meter = profiling.RateMeter()
        self.pose_callbacks: List[Callable] = []
        self.verbose = verbose
        self._key = _seed_key(node_cfg.seed)
        self._mount = _mount_of(node_cfg)
        self._warned_ring_overflow = False

    @property
    def poses(self) -> np.ndarray:
        """[T, 3] poses of the scans this node processed."""
        return self.global_map.poses

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
        with self.meter.tick(), profiling.span("node.scan", self.state.step):
            with profiling.span("step.load"):
                sc = scan_mod.load_laser(
                    np.asarray(ranges, np.float32), angle_min, angle_increment, range_max,
                    self.slam_cfg.scan, self.slam_cfg.map, mount=self._mount,
                    device=self.device,
                )
            # Key from the state's step counter, so a restored state resumes
            # the same random stream.
            key = rng.derive_key(self._key, self.state.step)
            self.state, pose, _cost = slam.slam_step(self.state, sc, key, self.slam_cfg)
            with profiling.span("node.pose_fetch"):  # the host waits for the device
                pose_np = pose.cpu().numpy().astype(np.float64)
            with profiling.span("node.export"):
                self.global_map.add_scan(sc.points, sc.valid, pose_np)
                self.global_map.add_pose(timestamp, pose_np, odom)
        for cb in self.pose_callbacks:
            cb(timestamp, pose_np)
        if self.cfg.ring_rows > 0 and not self._warned_ring_overflow:
            overflow = int(self.state.map.ring_overflow)
            if overflow > 0:
                # A cell that finds no ring row never builds and scores as
                # outside the map: say so the first time it happens.
                self._warned_ring_overflow = True
                print(
                    f"[ndtpso] WARNING: sparse ring overflow — {overflow} distinct cell(s) "
                    f"got no ring row (ring_rows={self.cfg.ring_rows} exhausted; newly "
                    "visited cells will not build). Increase NodeConfig.ring_rows by at "
                    "least the reported count.",
                    file=sys.stderr,
                )
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
        """Write the export bundle (``ndtpso_slam_node.cpp:131-174``); returns
        the files written."""
        if basename is None:
            basename = "ndtpso-" + time.strftime("%Y%m%d-%H%M%S")
        if self.cfg.ring_rows > 0:
            overflow = int(self.state.map.ring_overflow)
            if overflow > 0:
                print(
                    f"[ndtpso] ring overflow at shutdown: {overflow} distinct cell(s) never "
                    f"built (ring_rows={self.cfg.ring_rows} too small — "
                    f"{self.cfg.ring_rows + overflow} rows would have sufficed)",
                    file=sys.stderr,
                )
        og = og_bbox = None
        if self.state.og is not None:
            og = self.state.og.og.cpu().numpy()
            og_bbox = tuple(int(getattr(self.state.og, k))
                            for k in ("min_x", "max_x", "min_y", "max_y"))
        return export_mod.dump_map(
            basename,
            global_map=self.global_map,
            save_poses=True,
            save_points=True,
            save_image=self.cfg.save_map_images,
            map_cfg=self.slam_cfg.map,
            pso_cfg=self.slam_cfg.pso,
            og=og,
            og_bbox=og_bbox,
            og_cfg=self.slam_cfg.og,
            map_state=self.state.map,
        )

    def save_checkpoint(self, path: str) -> None:
        checkpoint.save(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        self.state = checkpoint.restore(path, self.state, self.slam_cfg)


class MultiSessionNode:
    """N concurrent SLAM sessions on one GPU: the reference's dual-LiDAR
    deployment (one OS process per sensor, ``launch/lidar_front.launch`` +
    ``lidar_back.launch``) as one process (JAX ``node.py:MultiSessionNode``).

    The sessions share one ``SlamConfig`` (their node configs must give
    equal ones); each session's start pose and mount transform come from its
    own ``NodeConfig``, and its key from ``seed + 101·i``, so session i
    replays a solo :class:`SlamNode` of seed ``seed + 101·i`` on its log.
    Scans go through ``parallel/sessions.py:SlamSessionPool``, so sensors at
    different rates interleave freely."""

    def __init__(self, node_cfgs: List[NodeConfig], verbose: bool = True, device="cuda"):
        if not node_cfgs:
            raise ValueError("need at least one session config")
        ref = node_cfgs[0].slam_config()
        if any(c.slam_config() != ref for c in node_cfgs[1:]):
            raise ValueError(
                "multi-session mode needs shape-identical SLAM configs (the sessions "
                "share one config); per-session init_pose / mount_trans may differ"
            )
        slam.validate_config(ref)
        self.cfgs = node_cfgs
        self.slam_cfg = ref
        self.verbose = verbose
        self.device = cfgm.resolve_device(device)
        n = len(node_cfgs)
        seeds = [c.seed + 101 * i for i, c in enumerate(node_cfgs)]
        keys = np.array([_seed_key(s) for s in seeds], np.int64)
        self.pool = SlamSessionPool(ref, np.stack([np.float32(c.init_pose) for c in node_cfgs]),
                                    keys, self.device)
        self._mounts = [_mount_of(c) for c in node_cfgs]
        self.global_maps = [export_mod.GlobalMap(keep_every=c.save_every) for c in node_cfgs]
        self._pending_meta: List[List] = [[] for _ in range(n)]
        self._steps = np.zeros(n, np.int64)

    def submit_scan(self, session: int, ranges, angle_min, angle_increment, range_max,
                    timestamp: float = 0.0, odom=None) -> None:
        sc = scan_mod.load_laser(
            np.asarray(ranges, np.float32), angle_min, angle_increment, range_max,
            self.slam_cfg.scan, self.slam_cfg.map, mount=self._mounts[session],
            device=self.device,
        )
        self.pool.submit(session, sc)
        self._pending_meta[session].append((timestamp, odom, sc))

    def poll(self):
        """One pooled step; returns {session: (timestamp, pose [3])}."""
        out = {}
        for sid, (pose, _cost) in self.pool.poll().items():
            ts, odom, sc = self._pending_meta[sid].pop(0)
            pose64 = np.asarray(pose, np.float64)
            self.global_maps[sid].add_scan(sc.points, sc.valid, pose64)
            self.global_maps[sid].add_pose(ts, pose64, odom)
            self._steps[sid] += 1
            out[sid] = (ts, pose64)
            if self.verbose:
                print(f"[ndtpso s{sid}] scan {self._steps[sid]}: pose "
                      f"({pose64[0]:.3f}, {pose64[1]:.3f}, {pose64[2]:.3f})", file=sys.stderr)
        return out

    def run_logs(self, logs) -> List[np.ndarray]:
        """Interleave N ScanLogs by timestamp (each sensor at its own rate)
        and run them to the end: scans with equal timestamps go in one poll.
        Returns per-session [T_i, 3] pose arrays."""
        n = len(logs)
        assert n == len(self.cfgs)
        events = sorted(
            (float(lg.timestamps[i]), s, i) for s, lg in enumerate(logs)
            for i in range(len(lg.ranges))
        )
        poses: List[List[np.ndarray]] = [[] for _ in range(n)]

        def drain_poll():
            for sid, (_ts, pose) in self.poll().items():
                poses[sid].append(pose)

        last_ts = None
        for ts, s, i in events:
            if last_ts is not None and ts != last_ts:
                drain_poll()
            lg = logs[s]
            self.submit_scan(s, lg.ranges[i], lg.angle_min, lg.angle_increment, lg.range_max,
                             timestamp=ts, odom=lg.odoms[i] if lg.odoms is not None else None)
            last_ts = ts
        while self.pool.pending():
            drain_poll()
        return [np.array(p) for p in poses]

    def shutdown(self, basename: Optional[str] = None) -> List[str]:
        """Per-session export bundles ``<basename>-s<i>.*``; returns the
        files written."""
        if basename is None:
            basename = "ndtpso-" + time.strftime("%Y%m%d-%H%M%S")
        files: List[str] = []
        for sid, cfg in enumerate(self.cfgs):
            st = self.pool.session_state(sid)
            og = og_bbox = None
            if st.og is not None:
                og = st.og.og.cpu().numpy()
                og_bbox = tuple(int(getattr(st.og, k))
                                for k in ("min_x", "max_x", "min_y", "max_y"))
            files += export_mod.dump_map(
                f"{basename}-s{sid}", global_map=self.global_maps[sid], save_poses=True,
                save_points=True, save_image=cfg.save_map_images, map_cfg=self.slam_cfg.map,
                pso_cfg=self.slam_cfg.pso, og=og, og_bbox=og_bbox, og_cfg=self.slam_cfg.og,
                map_state=st.map,
            )
        return files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ndtpso SLAM node (PyTorch port): run SLAM over recorded scan logs"
    )
    ap.add_argument("--scanlog", required=True, action="append",
                    help=".bag, .csv, .npz or .ndtlog scan log; repeat the flag to run "
                    "several sensors' logs as concurrent sessions (the reference's "
                    "lidar_front + lidar_back deployment in one process)")
    ap.add_argument("--config", action="append",
                    help="launch JSON (see launch/); with several --scanlog, one shared "
                    "config or one per log (shapes must match; init_pose / mount_trans "
                    "may differ)")
    ap.add_argument("--out", default=None, help="export basename")
    ap.add_argument("--checkpoint", help="save the final SLAM state here (.npz; one session)")
    ap.add_argument("--resume", help="restore the SLAM state saved by --checkpoint first "
                    "(one session)")
    ap.add_argument("--cost-mode", choices=list(slam.SLAM_COST_MODES), default=None,
                    help="exact | fast | fast_local | local_exact | rollout* (rollout "
                    "modes need --max-beams as a multiple of 128)")
    ap.add_argument("--optimizer", choices=sorted(OPTIMIZERS), default=None,
                    help="pso (deployed, core.cpp:50-116) | glir (GLIR-PSO, core.h:21-23; "
                    "the plain cost modes only)")
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
    ap.add_argument("--prefer-frontal-points", action="store_true",
                    help="the reference's PREFER_FRONTAL_POINTS beam decimation "
                    "(config.h:11; off upstream; lossy)")
    ap.add_argument("--save-images", action="store_true",
                    help="also write the rendered map image at shutdown")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=cfgm.DEFAULT_DEVICE,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)

    overrides = dict(
        cost_mode=args.cost_mode,
        optimizer=args.optimizer,
        pso_iterations=args.iterations,
        pso_population=args.population,
        frame_size_m=args.frame_size,
        cell_side_m=args.cell_side,
        max_beams=args.max_beams,
        seed=args.seed,
    )
    for flag, field in ((args.og, "build_og"), (args.recovery, "recovery"),
                        (args.prefer_frontal_points, "prefer_frontal_points"),
                        (args.save_images, "save_map_images")):
        if flag:
            overrides[field] = True

    def build_cfg(path):
        if path:
            return NodeConfig.from_json(path, **overrides)
        return dataclasses.replace(
            NodeConfig(), **{k: v for k, v in overrides.items() if v is not None}
        )

    from ndtpso_slam_tpu_torch.io.importers import load_log

    configs = args.config or [None]
    if len(args.scanlog) > 1:
        # Several sensors' logs as concurrent sessions of one pool.
        if args.resume or args.checkpoint:
            ap.error("--resume/--checkpoint are single-session only")
        if len(configs) == 1:
            configs = configs * len(args.scanlog)
        if len(configs) != len(args.scanlog):
            ap.error("--config count must be 1 or match the --scanlog count")
        logs = [load_log(p) for p in args.scanlog]
        mnode = MultiSessionNode([build_cfg(c) for c in configs], verbose=not args.quiet,
                                 device=args.device)
        t0 = time.time()
        poses = mnode.run_logs(logs)
        dt = time.time() - t0
        total = sum(len(p) for p in poses)
        print(f"[ndtpso] processed {total} scans over {len(logs)} sessions in {dt:.2f}s "
              f"({total / dt:.2f} Hz aggregate)", file=sys.stderr)
        for f in mnode.shutdown(args.out):
            print(f"[ndtpso] wrote {f}", file=sys.stderr)
        return 0
    if len(configs) != 1:
        ap.error("one --scanlog takes at most one --config")

    log = load_log(args.scanlog[0])
    node = SlamNode(build_cfg(configs[0]), verbose=not args.quiet, device=args.device)
    if args.resume:
        node.load_checkpoint(args.resume)
        print(f"[ndtpso] resumed from {args.resume}", file=sys.stderr)
    t0 = time.time()
    poses = node.run_log(log)
    dt = time.time() - t0
    print(
        f"[ndtpso] processed {len(poses)} scans in {dt:.2f}s ({len(poses) / dt:.2f} Hz)",
        file=sys.stderr,
    )
    if args.checkpoint:
        node.save_checkpoint(args.checkpoint)
        print(f"[ndtpso] checkpoint -> {args.checkpoint}", file=sys.stderr)
    for f in node.shutdown(args.out):
        print(f"[ndtpso] wrote {f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
