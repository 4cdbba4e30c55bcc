"""ctypes binding of the C++ golden reference (``native/golden/golden.cpp``).

Port of the golden half of ``ndtpso_slam_tpu/utils/native.py``, with the same
signatures and argument conventions: a double-precision NDT map (sparse hash
grid, raw per-slot points), the registration cost, the synchronous-gbest PSO
and the scan-synchronous SLAM loop, drawing from the engine's Threefry stream
bit for bit.  It is a reference only: the tests and ``chip_smoke.py`` hold
the port to it (pose RMSE <= 1e-3 m / 1e-3 rad, ``BASELINE.json``), and no
entry point of the port calls it.  Inputs are numpy arrays or CPU tensors.

The library is compiled at first use through the kernels' build route
(``ops/_build.py``), with the host C++ compiler (``$CXX``, else ``g++``,
else ``c++``) and ``native/Makefile``'s flags, into
``ndtpso_slam_tpu_torch/_build/``, named by a hash of the source, the
compiler and its version, and the flags.  It never writes ``native/build/``.
A failed build or load raises: there is no fallback.

Not ported: the runtime half (``libndtruntime.so``: the pose and map CSV,
gnuplot and PNG writers, the ``.ndtlog`` reader and writer).  The port
writes those files in Python (``utils/export.py``) and reads ``.ndtlog``
with numpy (``io/importers.py``).
"""

from __future__ import annotations

import ctypes as ct
from pathlib import Path
from typing import Tuple

import numpy as np

from ndtpso_slam_tpu_torch.ops import _build

NATIVE = Path(__file__).resolve().parents[2] / "native"

_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def _bind(lib: ct.CDLL) -> None:
    lib.golden_threefry.argtypes = [
        ct.c_uint32, ct.c_uint32, _U32, _U32, ct.c_long, _U32, _U32,
    ]
    lib.golden_map_new.restype = ct.c_void_p
    lib.golden_map_new.argtypes = [ct.c_double, ct.c_double, ct.c_int, ct.c_int]
    lib.golden_map_free.argtypes = [ct.c_void_p]
    lib.golden_map_update.argtypes = [ct.c_void_p, _F64, _F64, _U8, ct.c_long]
    lib.golden_map_build.argtypes = [ct.c_void_p]
    lib.golden_map_cell.argtypes = [ct.c_void_p, ct.c_long, _F64]
    lib.golden_map_cell.restype = ct.c_int
    lib.golden_cost.restype = ct.c_double
    lib.golden_cost.argtypes = [ct.c_void_p, _F64, _F64, _U8, ct.c_long]
    lib.golden_pso.argtypes = [
        ct.c_void_p, _F64, _U8, ct.c_long, _F64, _F64, ct.c_int, ct.c_int,
        ct.c_double, ct.c_double, ct.c_double, ct.c_double,
        ct.c_uint32, ct.c_uint32, _F64, _F64,
    ]
    lib.golden_slam_run.argtypes = [
        ct.c_double, ct.c_double, ct.c_int, ct.c_int, _F64, _U8,
        ct.c_long, ct.c_long, _F64, ct.c_int, ct.c_int,
        ct.c_double, ct.c_double, ct.c_double, ct.c_double,
        ct.c_uint32, ct.c_uint32, _F64,
    ]


LIB = _build.KernelLib("golden", "golden/golden.cpp", _bind, compiler="cxx", root=NATIVE)


def golden() -> ct.CDLL:
    """The golden library, built if needed, with its signatures set."""
    return _build.load(LIB)


def _f64(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), np.float64)


def _valid_arr(valid, n):
    if valid is None:
        return np.ones(n, np.uint8)
    return np.ascontiguousarray(np.asarray(valid).astype(np.uint8))


class GoldenMap:
    """Double-precision reference NDT map (sparse hash grid, raw points)."""

    def __init__(self, size_m: float, cell_side: float, slots: int = 100,
                 capacity: int = 50):
        self._lib = golden()
        self._h = self._lib.golden_map_new(size_m, cell_side, slots, capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.golden_map_free(self._h)
            self._h = None

    def update(self, pose, points, valid=None):
        points = _f64(points)
        n = len(points)
        self._lib.golden_map_update(self._h, _f64(pose), points, _valid_arr(valid, n), n)

    def build(self):
        self._lib.golden_map_build(self._h)

    def cell(self, index: int):
        """(mean [2], packed inverse covariance [3]) of a built cell, else None."""
        out = np.zeros(5)
        ok = self._lib.golden_map_cell(self._h, index, out)
        return (out[:2].copy(), out[2:].copy()) if ok else None

    def cost(self, pose, points, valid=None) -> float:
        points = _f64(points)
        n = len(points)
        return self._lib.golden_cost(self._h, _f64(pose), points, _valid_arr(valid, n), n)

    def pso(self, points, guess, deviation, key: Tuple[int, int],
            iterations=50, population=30, w=0.8, c1=2.0, c2=2.0,
            w_damping=1.0, valid=None):
        """One PSO solve; returns (pose [3], cost)."""
        points = _f64(points)
        n = len(points)
        pose = np.zeros(3)
        cost = np.zeros(1)
        self._lib.golden_pso(
            self._h, points, _valid_arr(valid, n), n, _f64(guess), _f64(deviation),
            iterations, population, w, c1, c2, w_damping,
            int(key[0]), int(key[1]), pose, cost,
        )
        return pose, float(cost[0])


def golden_threefry(key, c0, c1):
    """Threefry-2x32 (20 rounds) of the counter pairs (c0, c1) under key."""
    c0 = np.ascontiguousarray(np.asarray(c0), np.uint32)
    c1 = np.ascontiguousarray(np.asarray(c1), np.uint32)
    o0 = np.zeros_like(c0)
    o1 = np.zeros_like(c1)
    golden().golden_threefry(int(key[0]), int(key[1]), c0, c1, len(c0), o0, o1)
    return o0, o1


def golden_slam_run(points, valid, init_pose, size_m, cell_side, slots,
                    capacity, key, iterations, population, w=0.8, c1=2.0,
                    c2=2.0, w_damping=1.0):
    """Run the golden SLAM loop over a [T, N, 2] point log; returns poses
    [T, 3].  Scan i draws from ``threefry2x32(key, i, 0)``, as
    ``models/slam.py:run_offline`` does."""
    points = _f64(points)
    t, n = points.shape[:2]
    valid = np.ascontiguousarray(np.asarray(valid).astype(np.uint8))
    out = np.zeros((t, 3))
    golden().golden_slam_run(
        size_m, cell_side, slots, capacity, points.reshape(-1), valid.reshape(-1),
        t, n, _f64(init_pose), iterations, population, w, c1, c2, w_damping,
        int(key[0]), int(key[1]), out.reshape(-1),
    )
    return out
