"""ndtpso-tpu, PyTorch port: NDT-PSO scan matching and sequential SLAM on a
CUDA GPU.

A second package beside ``ndtpso_slam_tpu`` (the JAX reference).  Module
paths and public names mirror the JAX package.  Plain tensor code is
PyTorch; the JAX package's Pallas kernels become hand-written CUDA kernels
under ``csrc/``, built at first use.  This package never imports JAX.
"""

from ndtpso_slam_tpu_torch.config import (
    MapConfig,
    OccupancyGridConfig,
    PSOConfig,
    RecoveryConfig,
    ScanConfig,
    SlamConfig,
    resolve_device,
    scan_launch_config,
)
from ndtpso_slam_tpu_torch.models.cost import ndt_cost
from ndtpso_slam_tpu_torch.models.ndt_map import (
    MapSnapshot,
    NdtMapState,
    add_points,
    build,
    build_touched,
    init_map,
    snapshot,
)
from ndtpso_slam_tpu_torch.models.pso import PsoResult, pso_solve
from ndtpso_slam_tpu_torch.models.scan import Scan, load_laser
from ndtpso_slam_tpu_torch.models.slam import (
    SlamState,
    align,
    init_slam,
    run_offline,
    slam_step,
)

__version__ = "0.1.0"
