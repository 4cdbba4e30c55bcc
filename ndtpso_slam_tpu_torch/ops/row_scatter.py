"""In-place row scatter-set into flat fields: the CUDA kernel
``csrc/row_scatter.cu`` and its plain PyTorch version.

Port of ``experiments/scatter_unique_ab.py:_rowdma_kernel`` (the aliased
row-DMA scatter the flat fleet layout was measured with): for every field f
and update row i, ``ops[f][idx[i]] = vals[f][i]``, rows of any width W,
1-3 fields sharing one id stream.  Ids outside ``[0, rows)`` are dropped;
the fleet's callers map dropped ids to a junk row ``R`` of an ``[R + 1, W]``
operand first, as the TPU study did.

Several rows aimed at one target leave it equal to one of them, whole.
Which one is not part of the interface (the TPU kernel and PyTorch's
``index_copy_`` promise none); the kernel and its plain version both take
the last, so the card can hold them bit-equal.

:func:`row_scatter` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; it never falls back from
one to the other.  A call is one cooperative launch (clear the claim table,
claim, write, with grid barriers between), whatever M; the table, of
:func:`table_slots` slots, is a tensor kept per (device, stream), and no
memset clears it.
``row_scatter.LAUNCHES`` counts kernel launches.  The library is built by
``ops/_build.py``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ndtpso_slam_tpu_torch.ops import _build


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ndt_row_scatter.argtypes = [vp, i, ctypes.c_longlong, i] + [vp] * 6 + [i, vp, i, i, i, vp]
    lib.ndt_row_scatter.restype = i


LIB = _build.KernelLib("row_scatter", "row_scatter.cu", _bind)
# The kernel keys its claim table on int32 row ids.
MAX_ROWS = 2**31 - 1
# Threads per block of the kernel (csrc/row_scatter.cu: kThreads).
THREADS = 256


def table_slots(m: int) -> int:
    """Slots of the claim table, (int32 id, int32 winner) each, for m update
    rows: the least power of two >= 2 m."""
    return 1 << (2 * m - 1).bit_length()


def grid_blocks(m: int) -> int:
    """Blocks the launch asks for: a thread per table slot (the kernel caps
    them at what the device holds at once; its loops stride the grid)."""
    return -(-table_slots(m) // THREADS)


# The claim table each (device, stream) reuses, grown when a call needs more,
# so a call allocates nothing: calls on one stream run in order, and each
# clears the slots it uses, so none sees another's claims.
_TABLES: dict = {}


def _table(device: int, stream: int, slots: int) -> torch.Tensor:
    table = _TABLES.get((device, stream))
    if table is None or table.numel() < 2 * slots:
        table = _TABLES[(device, stream)] = torch.empty(2 * slots, dtype=torch.int32,
                                                        device=torch.device("cuda", device))
    return table


def winners(idx: torch.Tensor, rows: int):
    """(targets, rows that write them): the distinct in-range ids, and for
    each the last update row aimed at it."""
    order = torch.arange(idx.shape[0], device=idx.device)
    keep = (idx >= 0) & (idx < rows)
    uniq, inv = torch.unique(idx[keep], return_inverse=True)
    last = torch.full(uniq.shape, -1, dtype=torch.int64, device=idx.device)
    return uniq, last.scatter_reduce_(0, inv, order[keep], "amax")


def row_scatter_reference(ops: Sequence[torch.Tensor], idx: torch.Tensor,
                          vals: Sequence[torch.Tensor]):
    """Plain PyTorch version of :func:`row_scatter`; updates ``ops`` in place
    and returns them."""
    targets, rows = winners(idx.to(torch.int64), ops[0].shape[0])
    for op, v in zip(ops, vals):
        op[targets] = v[rows]
    return ops


def _check(ops, idx, vals):
    n = len(ops)
    if not 1 <= n <= 3 or len(vals) != n:
        raise ValueError(f"1-3 fields with one vals each, got {n} and {len(vals)}")
    if idx.dim() != 1:
        raise ValueError(f"idx must be [M], got {tuple(idx.shape)}")
    shape = ops[0].shape
    if len(shape) != 2:
        raise ValueError(f"operands must be [rows, W], got {tuple(shape)}")
    rows, width = shape
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows: at most {MAX_ROWS} (row ids are keyed as int32)")
    m = idx.shape[0]
    device = idx.get_device()
    for op in ops:
        if op.shape != shape or op.dtype != torch.float32 or not op.is_contiguous():
            raise ValueError("operands must be contiguous float32 [rows, W] of one shape")
        if op.get_device() != device:
            raise ValueError(f"operand on {op.device}, ids on {idx.device}")
    for v in vals:
        if v.shape != (m, width) or v.dtype != torch.float32 or v.get_device() != device:
            raise ValueError(f"vals must be float32 [{m}, {width}] on {idx.device}")
    return rows, width, m


def _ptrs(ts):
    return [t.data_ptr() for t in ts] + [None] * (3 - len(ts))


def _launch(ops, idx, vals):
    rows, width, m = _check(ops, idx, vals)
    if m == 0:
        return ops
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        idx = idx.to(torch.int64).contiguous()
    vals = [v if v.is_contiguous() else v.contiguous() for v in vals]
    device = idx.get_device()
    slots = table_slots(m)
    lib = _build.load(LIB)
    # The raw stream handle of the device's current stream, without building
    # a torch.cuda.Stream; the C entry makes the device current itself.
    stream = torch._C._cuda_getCurrentRawStream(device)
    table = _table(device, stream, slots)
    err = lib.ndt_row_scatter(idx.data_ptr(), m, rows, width, *_ptrs(ops), *_ptrs(vals), len(ops),
                              table.data_ptr(), slots, grid_blocks(m), device, stream)
    _build.check_launch(lib, err, "row_scatter")
    row_scatter.LAUNCHES += 1
    return ops


def row_scatter(ops: Sequence[torch.Tensor], idx: torch.Tensor, vals: Sequence[torch.Tensor]):
    """``ops[f][idx[i]] = vals[f][i]`` for 1-3 fields (float32 ``[rows, W]``
    operands, updated in place and returned; ``vals[f]`` [M, W]; ``idx`` [M]
    integer ids, out-of-range ids dropped).  CPU tensors run the plain
    version; CUDA tensors launch the kernel, once."""
    if idx.is_cuda:
        return _launch(ops, idx, vals)
    if idx.device.type != "cpu":
        raise ValueError(f"unsupported device {idx.device}")
    _check(ops, idx, vals)
    return row_scatter_reference(ops, idx, vals)


row_scatter.LAUNCHES = 0
