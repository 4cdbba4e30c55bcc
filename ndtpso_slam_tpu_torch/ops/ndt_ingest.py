"""One scan into a dense-ring NDT map in one launch: the CUDA kernel
``csrc/ndt_ingest.cu``.

Its plain PyTorch version is the other branch of
:func:`ndtpso_slam_tpu_torch.models.ndt_map.ingest_scan`: ``transform_points``,
``cell_index``, ``add_points``, then ``build_touched`` over this scan's ids
and the previous scan's.  The kernel adds a cell's beams in ascending beam
order (``index_add_``'s order on the CPU, and on CUDA under
``torch.use_deterministic_algorithms``), builds each distinct cell once, and
leaves the spare row C untouched, which nothing reads.

:func:`ndt_ingest` takes CUDA tensors only; it checks every field's shape,
dtype and contiguity and that all lie on one CUDA device, and raises on
anything else before it loads the library.  ``ndt_ingest.LAUNCHES`` counts
kernel launches.  The library is built by ``ops/_build.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ndtpso_slam_tpu_torch.ops import _build

# The map fields the kernel reads and writes, in the C entry's order, with
# each one's trailing shape after the C + 1 rows (S: window slots) and its
# kind: "f" the map's float dtype, "i" int32, "b" bool.
FIELDS = (
    ("mean_c", (2,), "f"), ("inv_cov", (3,), "f"), ("built", (), "b"), ("created", (), "b"),
    ("g_sum", (2,), "f"), ("g_count", (), "i"), ("g_cov", (3,), "f"),
    ("slot_sum", ("S", 2), "f"), ("slot_count", ("S",), "i"), ("slot_cov", ("S", 3), "f"),
    ("slot_idx", (), "i"), ("rot_count", (), "i"),
    ("cur_sum", (2,), "f"), ("cur_count", (), "i"), ("cur_m2", (3,), "f"),
)
# Beams of one scan the kernel takes: its shared memory (the centred points,
# the 2N ids and a table of >= 4N slots of 12 B) must fit one block's
# 227 KB at float64.
MAX_BEAMS = 2048
MAX_THREADS = 1024


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ndt_ingest.argtypes = ([i, ctypes.POINTER(vp)] + [vp] * 5
                               + [i, ctypes.c_double, ctypes.c_double] + [i] * 5
                               + [ctypes.c_longlong, i, vp])
    lib.ndt_ingest.restype = i


LIB = _build.KernelLib("ndt_ingest", "ndt_ingest.cu", _bind)


def table_shift(n: int) -> int:
    """The kernel's table has 2^(32 - shift) slots: the least power of two
    >= 4 n (at most half full with the 2 n ids)."""
    return 32 - (4 * n - 1).bit_length()


def smem_bytes(n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a launch: the centred points [n, 2], the 2n
    ids, and the table's keys, first positions and last beams."""
    return 2 * n * dtype.itemsize + 2 * n * 4 + 3 * 4 * (1 << (32 - table_shift(n)))


def threads(n: int) -> int:
    """Threads of the block: one per id of the 2n, whole warps, at most
    :data:`MAX_THREADS` (the kernel's loops stride the block)."""
    return min(MAX_THREADS, -(-2 * n // 32) * 32)


@functools.lru_cache(maxsize=None)
def _field_specs(cfg, dtype: torch.dtype) -> tuple:
    """(name, shape, dtype) of each map field for a map of ``cfg``."""
    rows, s = cfg.num_cells + 1, cfg.window_slots
    kinds = {"f": dtype, "i": torch.int32, "b": torch.bool}
    return tuple((name, (rows,) + tuple(s if d == "S" else d for d in tail), kinds[kind])
                 for name, tail, kind in FIELDS)


def _check(state, cfg, pose, points, valid, prev_ids) -> int:
    """The beam count n, after checking every tensor's shape, dtype and
    layout, then that all lie on one CUDA device; raises ValueError."""
    if cfg.ring_rows != 0:
        raise ValueError(f"the kernel takes a dense ring (ring_rows 0), got {cfg.ring_rows}")
    dtype = state.cur_sum.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the map must be float32 or float64, got {dtype}")
    if points.dim() != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be [N, 2], got {tuple(points.shape)}")
    n = points.shape[0]
    if not 1 <= n <= MAX_BEAMS:
        raise ValueError(f"{n} beams: the kernel takes 1 to {MAX_BEAMS}")
    tensors = [(name, getattr(state, name), shape, want)
               for name, shape, want in _field_specs(cfg, dtype)]
    tensors += [("pose", pose, (3,), dtype), ("points", points, (n, 2), dtype),
                ("valid", valid, (n,), torch.bool), ("prev_ids", prev_ids, (n,), torch.int32)]
    for name, t, shape, want in tensors:
        if t.shape != shape or t.dtype != want:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected {shape} {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    device = points.get_device()  # -1 on the CPU
    if not points.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {points.device}")
    for name, t, _, _ in tensors:
        if t.get_device() != device:
            raise ValueError(f"{name} on {t.device}, points on {points.device}")
    return n


def ndt_ingest(state, cfg, pose: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
               prev_ids: torch.Tensor) -> torch.Tensor:
    """Transform the scan ``points`` [N, 2] (mask ``valid`` [N]) by ``pose``
    [3], add it to the dense-ring map ``state`` in place, and build this
    scan's cells and ``prev_ids``' [N] (int32; ids >= C dropped), in one
    launch.  Returns the scan's cell ids [N] int32, C where a beam was
    dropped."""
    n = _check(state, cfg, pose, points, valid, prev_ids)
    device = points.get_device()
    ids = torch.empty(n, dtype=torch.int32, device=points.device)
    lib = _build.load(LIB)
    fields = (ctypes.c_void_p * len(FIELDS))(*[getattr(state, name).data_ptr()
                                               for name, _, _ in FIELDS])
    # The raw stream handle of the device's current stream, without building
    # a torch.cuda.Stream; the C entry makes the device current itself.
    stream = torch._C._cuda_getCurrentRawStream(device)
    dtype = state.cur_sum.dtype
    err = lib.ndt_ingest(int(dtype == torch.float64), fields, pose.data_ptr(), points.data_ptr(),
                         valid.data_ptr(), prev_ids.data_ptr(), ids.data_ptr(), n,
                         cfg.half_size_m, cfg.cell_side_m, cfg.cells_per_side, cfg.window_slots,
                         cfg.slot_capacity, table_shift(n), threads(n), smem_bytes(n, dtype),
                         device, stream)
    _build.check_launch(lib, err, "ndt_ingest")
    ndt_ingest.LAUNCHES += 1
    return ids


ndt_ingest.LAUNCHES = 0
