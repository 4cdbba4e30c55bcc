"""Small sizes of the benchmark's cells for the CPU tests: the same code
paths as the cells, with a small map, swarm, scan and window."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

NODE = {"config": {"node": {"frame_size_m": 40.0, "map_size_m": 40.0, "window_slots": 8,
                            "pso_population": 50, "pso_iterations": 30, "max_beams": 96}},
        "traffic": {"world_size_m": 12.0, "n_boxes": 3, "radius_m": 2.0, "n_beams": 90,
                    "sample_steps": 8, "trace_steps": 4}}
BATCH = {"config": {"pso": {"population": 64, "iterations": 5}, "max_beams": 96},
         "traffic": {"batch": 8, "pool": 16, "worlds": 2, "n_beams": 90, "sample_solves": 8,
                     "trace_calls": 2, "warmup_calls": 1}}
# The node with tracking-loss recovery on (RecoveryConfig's defaults, 8
# hypotheses, threshold 0.15) fed a kidnap log: the overrides that turn the
# patrol cell into it, at any size.  The limits are set from readings of 14
# seeds on an H100 at the patrol's widths (PERF.md §7, row 1).
RECOVERY = {"fitness_threshold": 0.15, "accept_fitness": 0.05,
            "spread": [3.0, 3.0, 3.141592653589793], "grid": [24, 24, 32], "grid_sigma": 0.5,
            "refine_sigma": 0.1, "grid_beam_stride": 0, "k_hypotheses": 8,
            "deviation": [0.3, 0.3, 0.3], "patch_cells": 192,
            "pso": {"iterations": 20, "population": 128, "w": 0.8, "c1": 2.0, "c2": 2.0,
                    "w_damping": 1.0},
            "min_valid_beams": 8}
KIDNAP = {"config": {"node": {"recovery": True, "recovery_fitness_threshold": 0.15,
                              "recovery_hypotheses": 8},
                     "recovery": RECOVERY,
                     "limits": {"pose_xy_p75_m": 0.005, "parted_pct": 40.0,
                                "event_xy_p75_m": 0.25, "event_th_p75_rad": 0.013,
                                "event_score_gap_p75": 0.02, "accept_differ_pct": 25.0}},
          "traffic": {"kind": "kidnap_log", "kidnap_every": 10, "jump_scans": [15, 25],
                      "sample_events": 32}}
# scan_launch_recovery.kidnap is the patrol cell with KIDNAP's overrides in
# files of its own (and two kidnaps in set-up): NODE makes it small.
CELLS = {"scan_launch.patrol": NODE, "batch_match.b256": BATCH, "batch_match.b16": BATCH,
         "scan_launch_recovery.kidnap": NODE}
SEED = 3000000007  # above 2**31, as the driver's seeds are


def run(workload, control=False, trace=False, seconds=0.5, seed=SEED, more=None):
    """One run of ``workload`` at its small size on the CPU, without the
    look for a chip: the result line's dict.  ``more`` overrides the small
    size further."""
    import time

    import torch

    from ndtbench import cell, harness

    torch.manual_seed(0)
    return harness.run_cell(workload, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), overrides=cell._merge(CELLS[workload], more),
                            control=control)
