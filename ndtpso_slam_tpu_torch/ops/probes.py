"""The TPU bring-up's single-op probes: the CUDA kernels ``csrc/probes.cu``
and their plain PyTorch versions.

Port of ``experiments/io_probe.py`` (:func:`io_probe`: four input-layout
probes of the rollout kernel, each a per-(solve, row) sum over the points
broadcast to ``[B, 8, 128]``) and ``experiments/mosaic_probe.py``
(:func:`mosaic_probe`: seven single-op probes on an ``[8, P]`` tile).  The
TPU scripts asked whether Mosaic compiled each op; the port computes the
same functions, so each kernel is held against its plain version.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; it never falls back from one to the
other.  A call on the card is one launch on the current stream; the C entry
makes the device current itself.  ``io_probe.LAUNCHES`` and
``mosaic_probe.LAUNCHES`` count kernel launches.  The library is built by
``ops/_build.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ndtpso_slam_tpu_torch.ops import _build, rng

IO_PROBES = ("min", "smem", "sten3", "sten4")
MOSAIC_PROBES = ("col3", "bool11", "slice11", "fori_small", "threefry", "dotgen", "bcast_out")
K2 = 25  # stencil offsets of radius 2
ROWS = 8  # the TPU tile's sublanes
LANES = 128  # the TPU output tile's lanes
N_DOT = 256  # k_dotgen's contraction length (mosaic_probe.py's N)
THREEFRY_KEY = (123, 456)
# smem's keys' and threefry's counters' dtypes: u32 words per element (an
# int64's low word comes first).
KEY_WORDS = {torch.int64: 2, torch.int32: 1, torch.uint32: 1}


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ndt_io_probe.argtypes = [i, vp, vp, ctypes.c_longlong, vp, i, i, i, vp]
    lib.ndt_io_probe.restype = i
    lib.ndt_mosaic_probe.argtypes = [i, vp, vp, ctypes.c_longlong, vp, i, i, i, vp]
    lib.ndt_mosaic_probe.restype = i
    lib.ndt_mosaic_max_dot_n.argtypes = []
    lib.ndt_mosaic_max_dot_n.restype = i


LIB = _build.KernelLib("probes", "probes.cu", _bind)


def _stream(index):
    """The raw handle of device ``index``'s current stream, without building
    a torch.cuda.Stream."""
    return torch._C._cuda_getCurrentRawStream(index)


# ------------------------------------------------------------- io_probe


def _io_check(name, src, keys):
    if name not in IO_PROBES:
        raise ValueError(f"unknown io probe {name!r}; expected one of {IO_PROBES}")
    if src.dtype != torch.float32:
        raise TypeError("the probe's input must be float32")
    b, n = src.shape[0], src.shape[-1]
    want = {"min": (b, ROWS, n), "smem": (b, ROWS, n), "sten3": (b, K2 * ROWS, n),
            "sten4": (b, K2, ROWS, n)}[name]
    if tuple(src.shape) != want:
        raise ValueError(f"{name}: input {tuple(src.shape)}, expected {want}")
    if name == "smem":
        if keys is None or tuple(keys.shape) != (b, 2) or keys.device != src.device:
            raise ValueError(f"smem needs keys [{b}, 2] on {src.device}")
        if keys.dtype not in KEY_WORDS:
            raise TypeError(f"smem's keys must be int64, int32 or uint32 words, not {keys.dtype}")
    return b, n


def io_probe_reference(name: str, src: torch.Tensor, keys: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`io_probe`."""
    b, n = _io_check(name, src, keys)
    if name in ("min", "smem"):
        rows = src
    else:
        view = src.view(b, K2, ROWS, n)
        rows = torch.zeros((b, ROWS, n), dtype=torch.float32, device=src.device)
        for k in range(K2):  # the TPU kernel's order: acc = acc + sten[k]
            rows = rows + view[:, k]
    total = rows.sum(dim=-1, keepdim=True)  # [B, 8, 1]
    if name == "smem":
        k0 = keys[:, 0].to(torch.int64) & 0xFFFFFFFF
        total = total + (k0 >> 8).to(torch.int32).to(torch.float32)[:, None, None]
    return total.expand(b, ROWS, LANES).contiguous()


def io_magnitudes(name: str, src: torch.Tensor) -> torch.Tensor:
    """Per output element of :func:`io_probe`, the sum of the magnitudes of
    the terms it adds up: the scale of the error a sum in another order
    makes."""
    return io_probe_reference("min" if name == "smem" else name, src.abs())


def io_probe(name: str, src: torch.Tensor, keys: torch.Tensor = None) -> torch.Tensor:
    """One of ``experiments/io_probe.py``'s probes: out [B, 8, 128] with
    ``out[b, r, :]`` the sum over the N points of

    * ``min``: ``pts[b, r]`` (src = pts [B, 8, N]);
    * ``smem``: the same plus ``f32(int32(k >> 8))``, k the u32 word of
      ``keys[b, 0]`` (keys [B, 2]: int64 words, whose low 32 bits are taken,
      or int32 / uint32 bit patterns, read as given);
    * ``sten4``: ``sum_k sten[b, k, r]`` over the 25 stencil offsets, in
      order (src = sten [B, 25, 8, N]);
    * ``sten3``: the same through the [B, 200, N] view (src = that view).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if src.device.type == "cpu":
        return io_probe_reference(name, src, keys)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    b, n = _io_check(name, src, keys)
    src = src.contiguous()
    key_ptr, key_stride = None, 0
    if name == "smem":  # keys[b, 0]'s first u32 word, in the caller's dtype
        key_ptr, key_stride = keys.data_ptr(), keys.stride(0) * KEY_WORDS[keys.dtype]
    out = torch.empty((b, ROWS, LANES), dtype=torch.float32, device=src.device)
    lib = _build.load(LIB)
    index = src.get_device()
    err = lib.ndt_io_probe(IO_PROBES.index(name), src.data_ptr(), key_ptr, key_stride,
                           out.data_ptr(), b, n, index, _stream(index))
    _build.check_launch(lib, err, f"io_probe {name}")
    io_probe.LAUNCHES += 1
    return out


io_probe.LAUNCHES = 0


# --------------------------------------------------------- mosaic_probe


def _mosaic_check(name, x, n_dot):
    if name not in MOSAIC_PROBES:
        raise ValueError(f"unknown mosaic probe {name!r}; expected one of {MOSAIC_PROBES}")
    if x.dim() != 2 or x.shape[0] != ROWS:
        raise ValueError(f"the tile must be [{ROWS}, P], got {tuple(x.shape)}")
    if name == "threefry":
        if x.dtype not in KEY_WORDS:
            raise TypeError(f"threefry takes u32 words as int64, int32 or uint32, not {x.dtype}")
    elif x.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 tile")
    p = x.shape[1]
    if name == "dotgen" and not 1 <= n_dot <= p:
        raise ValueError(f"dotgen contracts n_dot={n_dot} columns of a tile of {p}")
    return p


def mosaic_probe_reference(name: str, x: torch.Tensor, n_dot: int = N_DOT) -> torch.Tensor:
    """Plain PyTorch version of :func:`mosaic_probe`."""
    p = _mosaic_check(name, x, n_dot)
    dev = x.device
    if name == "col3":
        c = torch.tensor([1.0, 2.0] + [3.0] * (ROWS - 2), device=dev)[:, None]
        return x + c
    if name == "bool11":
        bc = torch.amin(x[0])  # NaN-propagating, as jnp.min
        return x + torch.where(bc < 0.5, bc, bc + 1.0)
    if name == "slice11":
        return x * (torch.cos(x[0:1, 0:1]) + 1.0)
    if name == "fori_small":
        a = x.sum(dim=1, keepdim=True)
        b = a[0:1, 0:1]
        w = torch.ones((), dtype=torch.float32, device=dev)
        for _ in range(5):
            a, b, w = a + 1.0, b * 1.01, w * 0.99
        return x + a + b + w
    if name == "threefry":
        x0, _ = rng.threefry2x32(THREEFRY_KEY, x, 0)
        return (x0 >> 8).to(torch.int32).to(torch.float32)
    if name == "dotgen":
        z = x[:, :n_dot].transpose(0, 1) @ x  # [n_dot, P]
        return z.sum(dim=0, keepdim=True).expand(ROWS, p).contiguous()
    return x.sum(dim=1, keepdim=True).expand(ROWS, p).contiguous()  # bcast_out


def mosaic_magnitudes(name: str, x: torch.Tensor, n_dot: int = N_DOT) -> torch.Tensor:
    """Per output element of :func:`mosaic_probe`, the sum of the magnitudes
    of the terms its sums add up (0 for the probes without a sum): the scale
    of the error a sum in another order makes."""
    a = x.abs()
    if name == "bcast_out":
        return a.sum(dim=1, keepdim=True).expand_as(x)
    if name == "fori_small":  # the row's sum, and row 0's through b
        return (a.sum(dim=1, keepdim=True) + a[0].sum() * 1.01**5).expand_as(x)
    if name == "dotgen":
        return (a[:, :n_dot].transpose(0, 1) @ a).sum(dim=0, keepdim=True).expand_as(x)
    return torch.zeros_like(x)


def mosaic_probe(name: str, x: torch.Tensor, n_dot: int = N_DOT) -> torch.Tensor:
    """One of ``experiments/mosaic_probe.py``'s probes on a tile x [8, P]
    (float32; integer u32 words for ``threefry``).  Returns float32 [8, P]:

    * ``col3``: ``x + c[r]``, c = (1, 2, 3, 3, ...);
    * ``bool11``: ``x + v``, bc the minimum of row 0 and
      ``v = bc if bc < 0.5 else bc + 1``;
    * ``slice11``: ``x * (cos(x[0, 0]) + 1)``;
    * ``fori_small``: ``x + a + b + w`` after five steps of
      ``(a + 1, b * 1.01, w * 0.99)`` from (row sums, row 0's sum, 1);
    * ``threefry``: ``f32(int32(x0 >> 8))``, x0 the first word of
      Threefry-2x32 of the counter (x, 0) under the key (123, 456); x holds
      u32 words as int64 (whose low 32 bits are taken) or as int32 / uint32
      bit patterns, read as given;
    * ``dotgen``: every row ``sum_n (x[:, :n_dot]^T x)[n, :]``;
    * ``bcast_out``: the row sums broadcast along the row.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch and no other device operation for a contiguous tile (a strided
    one is made contiguous first)."""
    if x.device.type == "cpu":
        return mosaic_probe_reference(name, x, n_dot)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    p = _mosaic_check(name, x, n_dot)
    lib = _build.load(LIB)
    if name == "dotgen" and n_dot > lib.ndt_mosaic_max_dot_n():
        raise ValueError(f"dotgen takes n_dot <= {lib.ndt_mosaic_max_dot_n()}, got {n_dot}")
    x = x.contiguous()
    xf, xi, xi_stride = x.data_ptr(), None, 0
    if name == "threefry":  # the counters' u32 words, in the caller's dtype
        xf, xi, xi_stride = None, x.data_ptr(), KEY_WORDS[x.dtype]
    out = torch.empty((ROWS, p), dtype=torch.float32, device=x.device)
    index = x.get_device()
    err = lib.ndt_mosaic_probe(MOSAIC_PROBES.index(name), xf, xi, xi_stride, out.data_ptr(), p,
                               n_dot if name == "dotgen" else 1, index, _stream(index))
    _build.check_launch(lib, err, f"mosaic_probe {name}")
    mosaic_probe.LAUNCHES += 1
    return out


mosaic_probe.LAUNCHES = 0
