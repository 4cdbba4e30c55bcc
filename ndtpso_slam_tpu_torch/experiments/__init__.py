"""Variant studies of the scoring and scatter kernels and the bring-up
probes, ported from the TPU scripts under ``experiments/``.  Each is an
entry point:

    python -m ndtpso_slam_tpu_torch.experiments.kernel_variants [--device cpu]
    python -m ndtpso_slam_tpu_torch.experiments.rollout_score_variants [--device cpu]
    python -m ndtpso_slam_tpu_torch.experiments.pallas_variants [--device cpu]
    python -m ndtpso_slam_tpu_torch.experiments.scatter_unique_ab [--device cpu]
    python -m ndtpso_slam_tpu_torch.experiments.io_probe [min|smem|sten3|sten4|all] [--device cpu]
    python -m ndtpso_slam_tpu_torch.experiments.mosaic_probe [--device cpu]
    python -m ndtpso_slam_tpu_torch.experiments.rollout_bisect STAGE|all [--binding] [--device cpu]

They run on the CUDA device unless given ``--device cpu``, which runs the
plain PyTorch versions (for rehearsal: no time printed there is a device
time).  Each keeps its TPU script's shapes, variants and printed lines.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ndtpso_slam_tpu_torch import config


def parse_args(description: str, argv=None, add_arguments=None):
    """(device, parsed arguments): ``--device`` and whatever
    ``add_arguments(parser)`` adds."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=config.DEFAULT_DEVICE, help="cuda (default) or cpu")
    if add_arguments is not None:
        add_arguments(ap)
    args = ap.parse_args(argv)
    return config.resolve_device(args.device), args


def parse_device(description: str, argv=None) -> torch.device:
    return parse_args(description, argv)[0]


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda {torch.cuda.get_device_name(device)}"
    return "cpu (plain PyTorch versions; host times, not device times)"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int, device: torch.device, warm: bool = True) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls enqueued
    back to back on one stream: CUDA events on a GPU, the host clock on the
    CPU.  One warm call first unless ``warm`` is False."""
    if warm:
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
