"""Variants of the frozen-correspondence scoring block: the CUDA kernels of
``csrc/score_variants.cu`` and their plain PyTorch versions.

Two kernels, for the variant studies under ``ndtpso_slam_tpu_torch/experiments/``:

* :func:`score_variants` replaces ``experiments/kernel_variants.py:make_kernel``
  and ``experiments/pallas_variants.py:make_scores``: for every solve b and
  particle j, ``out[b, j] = -Σₙ mask[b, n]·exp(-max(z, 0)/2)`` with
  ``z = w[b, n]·φ[b, j]``, by one of the routes below;
* :func:`score_block` replaces ``experiments/rollout_score_variants.py:make_kernel``:
  I serial iterations of the ``[N, P]`` score block and its column sums per
  solve, each iteration tied to the last by a block-wide minimum, as the
  rollout kernel's gbest step is.

Routes (``zroute``): ``f32`` (FP32 pipes, fused multiply-add chain), ``bf16``
(tensor cores, bf16 operands rounded to nearest even, f32 accumulation),
``tf32`` (tensor cores, operands rounded to TF32: 10 mantissa bits, to
nearest with ties away from zero), ``outer`` (FP32 pipes, feature-outer loop
with every product and sum rounded).  Reductions (``reduce``): ``cores``
(FP32 pipes) or ``mma`` (the mask as an mma operand; the scores and mask are
then rounded to bf16 on the bf16 route and to TF32 otherwise).  The plain
versions repeat every one of those roundings, so a kernel and its plain
version differ only by summation order and the ulps of ``exp``/``exp2``.

:func:`score_block` runs one solve per thread-block cluster of C CTAs,
split over particles (:func:`block_launch`: C by ``ops/_build.py:choose_cluster``,
the fewest waves, then the largest C); ``score_block.LAST`` holds the last
launch's cluster size, CTAs and particles per CTA.  Where the score is
``exp(-max(z, 0)/2)`` the kernels stage ``w`` as ``-w/2``
(:data:`HALF_STAGED_ROUTES`, :data:`HALF_STAGED_BLOCK`): a power of two, so
their ``z' = -z/2`` is the plain version's ``-0.5·z`` bit for bit.

The wrappers take the plain versions for tensors on the CPU and launch the
kernels for tensors on a CUDA device; they never fall back from one to the
other.  ``score_variants.LAUNCHES`` and ``score_block.LAUNCHES`` count kernel
launches.  The library is built by ``ops/_build.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ndtpso_slam_tpu_torch.ops import _build

FEATURES = 16
ZROUTES = ("f32", "bf16", "tf32", "outer")
REDUCES = ("cores", "mma")
BLOCK_VARIANTS = ("base", "exp2", "noclamp", "bf16mm", "bf16all")
# float32(0.5 * log2(e)) as the TPU study writes it, and its bfloat16 rounding.
LOG2E_HALF = 0.7213475204444817
LOG2E_HALF_BF16 = 0.72265625
# The routes and score-block variants whose kernels stage w as -w/2 (TF32:
# the rounded w, halved).  exp2 and bf16all multiply by constants that are
# not powers of two; bf16mm and the bf16 route multiply z by -1/2.
HALF_STAGED_ROUTES = ("f32", "tf32", "outer")
HALF_STAGED_BLOCK = ("base", "noclamp")


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ndt_score_variant.argtypes = [vp] * 4 + [i] * 6 + [vp]
    lib.ndt_score_variant.restype = i
    lib.ndt_score_variant_smem_bytes.argtypes = [i] * 3
    lib.ndt_score_variant_smem_bytes.restype = ctypes.c_size_t
    lib.ndt_score_block.argtypes = [vp] * 5 + [i] * 6 + [vp]
    lib.ndt_score_block.restype = i
    lib.ndt_score_block_smem_bytes.argtypes = [i] * 2
    lib.ndt_score_block_smem_bytes.restype = ctypes.c_size_t
    lib.ndt_score_block_max_active_clusters.argtypes = [i] * 3 + [ctypes.POINTER(i)]
    lib.ndt_score_block_max_active_clusters.restype = i


LIB = _build.KernelLib("score_variants", "score_variants.cu", _bind)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 (nearest even) -> float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: keep 10 mantissa bits,
    to nearest, ties away from zero; inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def pad16(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-pad the feature axis from 15 to 16 (the TPU studies' padding)."""
    if x.shape[dim] == FEATURES:
        return x
    if x.shape[dim] != FEATURES - 1:
        raise ValueError(f"expected 15 or 16 features on dim {dim}, got {tuple(x.shape)}")
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=dim)


def _z_outer(phit: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z [B, N, P] as the feature-outer loop: z = z + w_f·φ_f, f = 0..15,
    every product and sum rounded."""
    z = torch.zeros((w.shape[0], w.shape[1], phit.shape[2]), dtype=w.dtype, device=w.device)
    for f in range(FEATURES):
        z = z + w[:, :, f, None] * phit[:, None, f, :]
    return z


def score_variants_reference(phit, w, mask, zroute="f32", reduce="cores"):
    """Plain PyTorch version of :func:`score_variants`, with the kernel's
    roundings.  Same arguments and result."""
    _check_variant(zroute, reduce)
    phit = pad16(phit, 1)
    w = pad16(w, 2)
    if zroute == "bf16":
        phit, w = bf16_round(phit), bf16_round(w)
    elif zroute == "tf32":
        phit, w = tf32_round(phit), tf32_round(w)
    z = _z_outer(phit, w) if zroute == "outer" else w @ phit  # [B, N, P]
    s = torch.exp(-0.5 * torch.clamp(z, min=0.0))
    if reduce == "mma":
        rnd = bf16_round if zroute == "bf16" else tf32_round
        s, mask = rnd(s), rnd(mask)
    return -(mask[:, None, :] @ s)[:, 0, :]


def _check_variant(zroute, reduce):
    if zroute not in ZROUTES or reduce not in REDUCES:
        raise ValueError(f"unknown variant ({zroute!r}, {reduce!r}); routes {ZROUTES}, "
                         f"reductions {REDUCES}")
    if zroute == "outer" and reduce == "mma":
        raise ValueError("the outer route reduces on the cores only")


def _check_cuda(*tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors must share a device: {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("tensors must be float32")
    return dev


@functools.lru_cache(maxsize=None)
def _smem(index, n, entry, *route):
    """The dynamic shared memory of a launch (the library's ``entry`` for
    this N and route), checked against device ``index``'s limit once per
    shape."""
    smem = getattr(_build.load(LIB), entry)(n, *route)
    limit = _build.device_limits(index)[0]
    if smem + _build.STATIC_SMEM > limit:
        raise ValueError(f"N={n} needs {smem} B of shared memory; the device allows {limit} B")
    return smem


def _on(index):
    """The device context a launch on device ``index`` needs: none when it
    is the current device already (the common case costs no switch)."""
    return (contextlib.nullcontext() if index == torch.cuda.current_device()
            else torch.cuda.device(index))


def _launch_variants(phit, w, mask, zroute, reduce, tile):
    dev = _check_cuda(phit, w, mask)
    phit = pad16(phit, 1).contiguous()
    w = pad16(w, 2).contiguous()
    mask = mask.contiguous()
    b, n = mask.shape
    p = phit.shape[2]
    if w.shape != (b, n, FEATURES) or phit.shape[0] != b:
        raise ValueError(f"bad shapes: phit {tuple(phit.shape)}, w {tuple(w.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if tile < 16 or tile % 16:
        raise ValueError(f"tile {tile} must be a positive multiple of 16")
    lib = _build.load(LIB)
    index = phit.get_device()
    route = (ZROUTES.index(zroute), REDUCES.index(reduce))
    _smem(index, n, "ndt_score_variant_smem_bytes", *route)
    out = torch.empty((b, p), dtype=torch.float32, device=dev)
    with _on(index):
        err = lib.ndt_score_variant(phit.data_ptr(), w.data_ptr(), mask.data_ptr(),
                                    out.data_ptr(), b, n, p, tile, *route,
                                    torch._C._cuda_getCurrentRawStream(index))
    _build.check_launch(lib, err, "score_variants")
    score_variants.LAUNCHES += 1
    return out


def score_variants(
    phit: torch.Tensor,  # [B, 15|16, P] f32, feature-major
    w: torch.Tensor,  # [B, N, 15|16] f32
    mask: torch.Tensor,  # [B, N] f32
    zroute: str = "f32",
    reduce: str = "cores",
    tile: int = 2048,
) -> torch.Tensor:  # [B, P]
    """Frozen-correspondence costs of B solves' P particles by one variant;
    ``tile`` is the particles per block (a multiple of 16).  Fifteen
    features are zero-padded to sixteen, as the TPU studies pad them.  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    _check_variant(zroute, reduce)
    if phit.device.type == "cpu":
        return score_variants_reference(phit, w, mask, zroute, reduce)
    if phit.device.type != "cuda":
        raise ValueError(f"unsupported device {phit.device}")
    return _launch_variants(phit, w, mask, zroute, reduce, tile)


score_variants.LAUNCHES = 0


def _block_score(z: torch.Tensor, variant: str) -> torch.Tensor:
    """The per-point score of a :func:`score_block` variant."""
    zc = torch.clamp(z, min=0.0)
    if variant == "exp2":
        return torch.exp2(-LOG2E_HALF * zc)
    if variant == "noclamp":
        return torch.exp(-0.5 * z)
    if variant == "bf16all":
        e = bf16_round(bf16_round(zc) * -LOG2E_HALF_BF16)  # the bf16 product of two bf16s
        return bf16_round(torch.exp2(e))
    return torch.exp(-0.5 * zc)


def score_block_reference(phit, w, iterations, variant="base"):
    """Plain PyTorch version of :func:`score_block`.  Same arguments and
    results."""
    if variant not in BLOCK_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {BLOCK_VARIANTS}")
    carry = torch.zeros(phit.shape[0], dtype=torch.float32, device=phit.device)
    wz = bf16_round(w) if variant.startswith("bf16") else w
    c = None
    for _ in range(iterations):
        pv = phit * (1.0 + carry * 0.0)[:, None, None]
        if variant.startswith("bf16"):
            pv = bf16_round(pv)
        c = -_block_score(wz @ pv, variant).sum(dim=1)  # [B, P]
        carry = carry + c.min(dim=1).values * 0.0
    return carry, c


def block_launch(batch, population, clusters_held, smem_bytes, smem_limit, cluster=None):
    """E3's launch geometry, a pure function: one solve per cluster of C
    CTAs, C from :func:`ops._build.choose_cluster` over ``clusters_held(C)``
    (the most clusters of C CTAs of the kernel, its threads and registers
    included, the device holds at once) unless ``cluster`` is given; B·C
    CTAs, each scoring a contiguous ceil(P / C) of the particles.  Returns
    dict(cluster, ctas, per_cta)."""
    c = cluster or _build.choose_cluster(batch, lambda _c: smem_bytes, smem_limit, clusters_held)
    return dict(cluster=c, ctas=batch * c, per_cta=-(-population // c))


def _block_clusters_held(lib, n, vidx, cluster, dev):
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.ndt_score_block_max_active_clusters(n, vidx, cluster, ctypes.byref(out))
    _build.check_launch(lib, err, "score_block", "occupancy query")
    return out.value


def _launch_block(phit, w, iterations, variant, cluster=None, sms=None):
    dev = _check_cuda(phit, w)
    phit, w = phit.contiguous(), w.contiguous()
    b, f, p = phit.shape
    n = w.shape[1]
    if f != FEATURES or w.shape != (b, n, FEATURES):
        raise ValueError(f"bad shapes: phit {tuple(phit.shape)}, w {tuple(w.shape)}")
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    lib = _build.load(LIB)
    index = phit.get_device()
    vidx = BLOCK_VARIANTS.index(variant)
    smem = _smem(index, n, "ndt_score_block_smem_bytes", vidx)
    c_size = _build.device_cluster(
        ("score_block", vidx, n), b, lambda _c: smem,
        lambda cc: _block_clusters_held(lib, n, vidx, cc, dev), dev, cluster)
    c = torch.empty((b, p), dtype=torch.float32, device=dev)
    carry = torch.empty((b,), dtype=torch.float32, device=dev)
    with _on(index):
        err = lib.ndt_score_block(phit.data_ptr(), w.data_ptr(), c.data_ptr(), carry.data_ptr(),
                                  None if sms is None else sms.data_ptr(), b, n, p, iterations,
                                  vidx, c_size, torch._C._cuda_getCurrentRawStream(index))
    _build.check_launch(lib, err, "score_block")
    score_block.LAUNCHES += 1
    # The geometry of block_launch, at the C chosen (and cached) above.
    score_block.LAST = block_launch(b, p, None, smem, None, cluster=c_size)
    return carry, c


def block_sms(phit, w, iterations, variant="base", cluster=None):
    """One :func:`score_block` launch on the card that also records each
    CTA's SM: (the SMs its CTAs ran on, its CTAs).  Counts as a launch."""
    if variant not in BLOCK_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {BLOCK_VARIANTS}")
    if phit.device.type != "cuda":
        raise ValueError(f"block_sms reads the SMs of a launch on the card, not {phit.device}")
    probe = torch.empty(phit.shape[0] * 8, dtype=torch.int32, device=phit.device)
    _launch_block(phit, w, iterations, variant, cluster, sms=probe)
    ctas = score_block.LAST["ctas"]
    return int(torch.unique(probe[:ctas]).numel()), ctas


def score_block(
    phit: torch.Tensor,  # [B, 16, P] f32
    w: torch.Tensor,  # [B, N, 16] f32
    iterations: int,
    variant: str = "base",
    cluster=None,
):
    """I serial iterations of z = w·φᵀ, s = score(z), c = -Σₙ s per solve,
    each scaling φ by ``1 + carry·0`` and adding ``min(c)·0`` to the carry.
    Returns (carry [B], the last iteration's c [B, P]); the carry is 0 unless
    some c is NaN.  CPU tensors run the plain version; CUDA tensors launch
    the kernel, one solve per cluster of the chosen C (``cluster``: forced,
    for tests)."""
    if variant not in BLOCK_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {BLOCK_VARIANTS}")
    if phit.device.type == "cpu":
        return score_block_reference(phit, w, iterations, variant)
    if phit.device.type != "cuda":
        raise ValueError(f"unsupported device {phit.device}")
    return _launch_block(phit, w, iterations, variant, cluster)


score_block.LAUNCHES = 0
score_block.LAST = None
