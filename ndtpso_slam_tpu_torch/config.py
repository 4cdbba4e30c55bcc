"""Configuration dataclasses of the PyTorch port.

Counterpart of ``ndtpso_slam_tpu/config.py``: the same frozen dataclasses,
fields and defaults, so a configuration reads the same in both packages.  The
one change is :attr:`SlamConfig.dtype`, a ``torch`` dtype.

Devices are explicit.  :func:`resolve_device` is the one place that turns a
``device=`` argument into a ``torch.device``; the main path defaults to
``"cuda"`` and raises when no GPU is present instead of carrying on quietly on
the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# Defaults mirroring the reference's compile-time defines (config.h:5-25).
NDT_MAX_POINTS_PER_CELL = 50
NDT_WINDOW_SIZE = 100
LASER_IGNORE_EPSILON = 0.1
PSO_ITERATIONS = 50
PSO_POPULATION_SIZE = 30
PSO_W = 0.8
PSO_C1 = 2.0
PSO_C2 = 2.0
PSO_W_DAMPING = 1.0  # "w_dumping" in the reference

# Node defaults (ndtpso_slam_node.hpp:17-34, launch/scan.launch:10-16).
DEFAULT_FRAME_SIZE_M = 300
DEFAULT_CELL_SIZE_M = 0.5
DEFAULT_OG_CELL_SIZE_M = 0.1
DEFAULT_RATE_HZ = 10

# NDTFrame::align's cold-start particle deviation (ndtframe.cpp:253).
FIRST_DEVIATION: Tuple[float, float, float] = (0.1, 0.1, 3.1415e-3)
# Near-zero deviation used to seed the initial global best (core.cpp:53).
ZERO_DEVIATION: Tuple[float, float, float] = (1e-4, 1e-4, 1e-5)

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Particle swarm hyper-parameters (reference config.h:27-38)."""

    iterations: int = PSO_ITERATIONS
    population: int = PSO_POPULATION_SIZE
    w: float = PSO_W
    c1: float = PSO_C1
    c2: float = PSO_C2
    w_damping: float = PSO_W_DAMPING


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Geometry and sliding-window budget of the NDT grid map
    (ndtframe.cpp:19-66, ndtcell.h:13-18)."""

    size_m: float = float(DEFAULT_FRAME_SIZE_M)
    cell_side_m: float = DEFAULT_CELL_SIZE_M
    window_slots: int = NDT_WINDOW_SIZE
    slot_capacity: int = NDT_MAX_POINTS_PER_CELL
    # Stencil patch side in cells (0 = whole grid).  The port binds stencils
    # by direct gather, which needs no patch; a value > 0 is kept for config
    # parity and rejected by the binder (ROADMAP A6).
    stencil_patch_cells: int = 0
    # Sparse ring rows (0 = dense).  The port runs the dense ring only;
    # ring_rows > 0 is listed in ROADMAP (A5) and raises.
    ring_rows: int = 0

    @property
    def cells_per_side(self) -> int:
        # uint16(ceil(width / cell_side)), ndtframe.cpp:27-28
        return int(math.ceil(self.size_m / self.cell_side_m))

    @property
    def num_cells(self) -> int:
        return self.cells_per_side * self.cells_per_side

    @property
    def half_size_m(self) -> float:
        return self.size_m / 2.0

    def patch_cells_for_range(self, range_max_m: float, radius: int = 2,
                              margin_cells: int = 8) -> int:
        """Smallest stencil patch (multiple of 8) covering a scan of
        ``range_max_m`` around its anchor, capped at the grid side."""
        need = int(math.ceil(2.0 * range_max_m / self.cell_side_m)) + 2 * radius + margin_cells
        need = (need + 7) // 8 * 8
        return min(need, self.cells_per_side)


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Laser-scan ingestion parameters (ndtframe.cpp:144-185)."""

    max_beams: int = 1024
    ignore_epsilon: float = LASER_IGNORE_EPSILON
    # PREFER_FRONTAL_POINTS beam decimation (config.h:11); off upstream.
    prefer_frontal_points: bool = False


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    """Occupancy-grid raster config (ndtframe.cpp:32-45)."""

    cell_size_m: float = DEFAULT_OG_CELL_SIZE_M
    enabled: bool = True


RECOVERY_AUTO_STRIDE_MIN_CELLS = 65536


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Tracking-loss detection and relocalization (``models/slam.py``).  Same
    fields and defaults as the JAX package: off by default; a scan's match
    fitness (mean exact NDT score per valid beam) below ``fitness_threshold``
    triggers the K-hypothesis relocalization around the last trusted pose,
    whose pose is adopted only if it beats the failed align and its fitness
    lies in [``accept_fitness``, 1]; a scan with fewer than
    ``min_valid_beams`` valid beams dead-reckons and is not ingested.
    ``grid_beam_stride`` 0 is auto: 2 at ``RECOVERY_AUTO_STRIDE_MIN_CELLS``
    map cells or more, else 1.  ``patch_cells`` is the side of the binder's
    window around the last pose (0, or at least the grid's side: the whole
    table).  ``exchange_every`` is kept for configuration parity: the
    relocalization's swarms run independently, as in the JAX package."""

    enabled: bool = False
    fitness_threshold: float = 0.15
    accept_fitness: float = 0.05
    spread: Tuple[float, float, float] = (3.0, 3.0, math.pi)
    grid: Tuple[int, int, int] = (24, 24, 32)
    grid_sigma: float = 0.5
    refine_sigma: float = 0.1
    grid_beam_stride: int = 0
    k_hypotheses: int = 8
    deviation: Tuple[float, float, float] = (0.3, 0.3, 0.3)
    patch_cells: int = 192
    pso: PSOConfig = PSOConfig(iterations=20, population=128)
    exchange_every: int = 5
    min_valid_beams: int = 8


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Full sequential-SLAM configuration: the ``scan.launch`` analogue."""

    pso: PSOConfig = PSOConfig()
    map: MapConfig = MapConfig()
    scan: ScanConfig = ScanConfig()
    og: OccupancyGridConfig = OccupancyGridConfig(enabled=False)
    recovery: RecoveryConfig = RecoveryConfig()
    first_deviation: Tuple[float, float, float] = FIRST_DEVIATION
    # align() widens the search to twice the last inter-scan motion
    # (ndtframe.cpp:253).
    deviation_scale: float = 2.0
    # One of models/slam.py:SLAM_COST_MODES.
    cost_mode: str = "exact"
    optimizer: str = "pso"
    # Rollout cost modes only: stop a solve once its global best has stalled
    # this many consecutive iterations (0 = the fixed budget, core.cpp:78).
    solver_early_exit: int = 0
    dtype: object = torch.float32


def scan_launch_config() -> SlamConfig:
    """The canonical ``launch/scan.launch:10-16`` configuration."""
    return SlamConfig(
        pso=PSOConfig(iterations=30, population=50),
        map=MapConfig(size_m=300.0, cell_side_m=0.5),
        og=OccupancyGridConfig(cell_size_m=0.1, enabled=True),
    )
