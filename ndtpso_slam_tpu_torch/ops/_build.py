"""One build route for the port's native libraries.

Each kernel library is one source under ``csrc/`` (which may include the
shared ``csrc/*.cuh`` headers), compiled by ``nvcc`` into a shared library
with a plain C interface and bound with ``ctypes``; the C++ golden reference
(``utils/native.py``) takes the same route with the host C++ compiler.  A
library is built at first use into ``ndtpso_slam_tpu_torch/_build/``, named
by a hash of its source, the headers, the compiler and its version, and the
flags, so an edit rebuilds it and nothing else does.  :func:`build` compiles
several libraries at once, one compiler process each, all started together.
A failed build raises with the compiler's output: there is no fallback to
the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, List

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math (approximate expf/exp2f/sinf/cosf) and no FMA
# contraction, so the kernels round every + - * / as the plain versions do.
# -Xptxas -v writes each kernel's registers, shared memory and spills to the
# build log beside the library.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# native/Makefile's CXXFLAGS, then -shared: the host C++ compiler's flags.
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17", "-fPIC", "-shared")


@dataclasses.dataclass(frozen=True)
class KernelLib:
    """A native library: its name, its source (a path under ``root``), a
    function that sets the ctypes signatures of its C entries, and its
    compiler: ``nvcc`` (a kernel library, :data:`NVCC_FLAGS`, the shared
    ``csrc/*.cuh`` headers) or ``cxx``, the host C++ compiler
    (:data:`CXX_FLAGS`)."""

    name: str
    source: str
    bind: Callable[[ctypes.CDLL], None]
    compiler: str = "nvcc"
    root: Path = CSRC

    def flags(self) -> tuple:
        return NVCC_FLAGS if self.compiler == "nvcc" else CXX_FLAGS

    def path(self) -> Path:
        data = (self.root / self.source).read_bytes()
        if self.compiler == "nvcc":
            for header in sorted(CSRC.glob("*.cuh")):
                data += header.read_bytes()
        exe = _compiler(self.compiler)
        data += " ".join((exe, _version(exe), *self.flags())).encode()
        return BUILD_DIR / f"{self.name}-{hashlib.sha256(data).hexdigest()[:16]}.so"


def _compiler(kind: str) -> str:
    """The path of the ``nvcc`` (looked for on PATH, then in CUDA_HOME/bin)
    or ``cxx`` (``$CXX``, else ``g++``, else ``c++``) compiler."""
    if kind == "cxx":
        for name in (os.environ.get("CXX"), "g++", "c++"):
            found = name and shutil.which(name)
            if found:
                return found
        raise RuntimeError("no C++ compiler found ($CXX, g++, c++)")
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")
    return str(path)


@functools.lru_cache(maxsize=None)
def _version(exe: str) -> str:
    return subprocess.run([exe, "--version"], capture_output=True, text=True).stdout


def build(*libs: KernelLib) -> List[Path]:
    """Compile every library that is not built yet, one compiler process each,
    all running at once.  Returns the libraries' paths; each build log is the
    path with the suffix ``.log``."""
    jobs = []
    for lib in libs:
        path = lib.path()
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(lib.compiler), *lib.flags(), "-o", str(tmp), str(lib.root / lib.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((lib, path, tmp, cmd, proc))
    failed = []
    for lib, path, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.name} build failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [lib.path() for lib in libs]


@functools.lru_cache(maxsize=None)
def load(lib: KernelLib) -> ctypes.CDLL:
    """The library, built if needed, with its signatures set."""
    (path,) = build(lib)
    cdll = ctypes.CDLL(str(path))
    if lib.compiler == "nvcc":
        cdll.ndt_cuda_error_string.argtypes = [ctypes.c_int]
        cdll.ndt_cuda_error_string.restype = ctypes.c_char_p
    lib.bind(cdll)
    return cdll


def u32_words(keys, device):
    """Key words [B, 2] as the kernels take them: u32 words carried as their
    int32 bit patterns, contiguous on ``device``.  An int32 tensor already
    contiguous there is returned as it is, with no device operation; other
    integer words (int64, uint32) keep their low 32 bits.  Host words (a
    sequence of (k0, k1) pairs of integers, or one pair) are made on the
    host and sent with one copy that does not wait for the stream."""
    device = torch.device(device)
    if not isinstance(keys, torch.Tensor):
        words = (torch.tensor(keys, dtype=torch.int64).reshape(-1, 2) & 0xFFFFFFFF).to(torch.int32)
        return words.to(device, non_blocking=True)
    if (keys.dtype == torch.int32 and keys.is_contiguous() and keys.device.type == device.type
            and (device.index is None or keys.device.index == device.index)):
        return keys
    return (keys.to(device).to(torch.int64) & 0xFFFFFFFF).to(torch.int32).contiguous()


# Cluster sizes a whole-solve kernel (K1, K2) may run one solve on: powers
# of two up to the portable maximum (csrc/pso_common.cuh: kMaxCluster).
CLUSTER_SIZES = (1, 2, 4, 8)
# Static shared memory a whole-solve CTA keeps beside its dynamic part
# (argmin and sum scratch, the global best), an upper bound.
STATIC_SMEM = 1024


def slice_floats(population: int) -> int:
    """Floats of one CTA's slice of a whole-solve kernel's global-route
    scratch (csrc/pso_common.cuh: slice_floats): the particle state [10, P]
    and the partial costs [P + 1]."""
    return 11 * population + 1


def waves(batch: int, held: int) -> int:
    """Waves of ``batch`` clusters on a device that holds ``held`` at once."""
    return -(-batch // held)


def choose_cluster(batch: int, smem_bytes: Callable[[int], int], smem_limit: int,
                   clusters_held: Callable[[int], int]) -> int:
    """The cluster size C a whole-solve kernel runs each of ``batch`` solves
    on: among the sizes of :data:`CLUSTER_SIZES` whose CTA fits the shared
    memory (``smem_bytes(C)`` dynamic bytes plus :data:`STATIC_SMEM` within
    ``smem_limit``), the one that needs the fewest waves, ``ceil(batch /
    clusters_held(C))`` with ``clusters_held(C)`` the most clusters of C the
    device holds at once; ties go to the largest C, which spreads a solve's
    points over the most SMs.  Raises if no size fits."""
    best = None
    for c in CLUSTER_SIZES:
        if smem_bytes(c) + STATIC_SMEM > smem_limit:
            continue
        held = clusters_held(c)
        if held > 0 and (best is None or waves(batch, held) <= best[0]):
            best = (waves(batch, held), c)
    if best is None:
        raise ValueError(
            f"no cluster size in {CLUSTER_SIZES} fits: a CTA needs "
            f"{smem_bytes(CLUSTER_SIZES[-1]) + STATIC_SMEM} B of shared memory at C="
            f"{CLUSTER_SIZES[-1]}; the device allows {smem_limit} B"
        )
    return best[1]


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """(shared memory per block, opt-in; SM count) of CUDA device ``index``,
    read once."""
    props = torch.cuda.get_device_properties(index)
    return props.shared_memory_per_block_optin, props.multi_processor_count


# device_cluster's choices, by (kernel instantiation and shape, batch,
# device index): the occupancy query runs once per shape, not per launch.
CHOSEN: dict = {}


def device_cluster(shape_key, batch: int, smem_bytes: Callable[[int], int],
                   clusters_held: Callable[[int], int], device, cluster=None) -> int:
    """:func:`choose_cluster` on ``device``'s shared memory per block and its
    occupancy query ``clusters_held``, cached in :data:`CHOSEN` under
    (``shape_key``, ``batch``, device index); or the forced ``cluster``
    (tests), checked against the shared memory."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if cluster is None:
        key = (shape_key, batch, index)
        chosen = CHOSEN.get(key)
        if chosen is None:
            chosen = CHOSEN[key] = choose_cluster(batch, smem_bytes, device_limits(index)[0],
                                                  clusters_held)
        return chosen
    limit = device_limits(index)[0]
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster {cluster} is not one of {CLUSTER_SIZES}")
    if smem_bytes(cluster) + STATIC_SMEM > limit:
        raise ValueError(f"cluster {cluster}: a CTA needs {smem_bytes(cluster)} B of shared "
                         f"memory; the device allows {limit} B")
    return cluster


def check_launch(cdll: ctypes.CDLL, err: int, name: str, what: str = "kernel launch") -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(
            f"{name} {what} failed: {cdll.ndt_cuda_error_string(err).decode()}"
        )


def max_active_clusters(cdll: ctypes.CDLL, entry: str, device, n_pts: int, population: int,
                        cluster: int, last: int) -> int:
    """The most clusters of ``cluster`` CTAs ``device`` holds at once for a
    whole-solve kernel at this shape (cudaOccupancyMaxActiveClusters), from
    the library's C entry ``entry(n_pts, population, cluster, last, out)``."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(cdll, entry)(n_pts, population, cluster, last, ctypes.byref(out))
    check_launch(cdll, err, entry, "occupancy query")
    return out.value
