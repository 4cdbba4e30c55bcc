"""Counter-based RNG with a frozen draw protocol (Threefry-2x32).

Port of ``ndtpso_slam_tpu/ops/rng.py``: the same 20-round Threefry-2x32 in
pure counter mode, so the port consumes the bit-identical uniform stream of
the JAX engine, the C++ golden model and the CUDA rollout kernel.

Draw protocol for a PSO solve with P particles, I iterations (each entry is
one threefry counter -> one pair of uniforms):

  pair index                        use
  ------------------------------   -------------------------------------------
  k               (k=0..2)         gbest-init dim k: u = lo word (hi unused)
  3 + j*3 + k                      particle j init, dim k: u = lo word
  3 + P*3 + i*P*3 + j*3 + k        iter i, particle j, dim k: (r1, r2) = pair

Uniforms are u32 -> [0, 1) via ``(bits >> 8) * 2^-24``.

PyTorch on the CPU has no uint32 shifts, so every 32-bit word lives in an
int64 lane masked with ``0xFFFFFFFF``: the values stay below 2^32 and the
largest intermediate (a word shifted left by at most 29) below 2^61, so no
lane ever overflows.

The turbo solver modes (``rng_mode="native"``) draw from Philox4x32-10
instead: the JAX package's turbo modes use the TPU's hardware generator,
which has no counterpart on a GPU and whose stream is not stable even across
TPU versions, so the port defines its own counter layout (see
:func:`philox_uniforms`) and holds turbo solves to accuracy gates, never to
the JAX package's bits.  The CUDA kernels consume the same stream bit for
bit.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
U01_SCALE = 1.0 / (1 << 24)  # exact in float32


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def _word(v, device=None) -> torch.Tensor:
    """An integer (tensor, numpy or Python) as int64 lanes of u32 words."""
    return torch.as_tensor(v, device=device).to(torch.int64) & _M32


def _threefry(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on u32 words held as Python ints or as int64
    tensors (the same code serves both)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for block in range(5):
        for r in _ROT_A if block % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _M32
    return x0, x1


def threefry2x32(key, c0, c1):
    """Threefry-2x32, 20 rounds.  key: (k0, k1) u32 words; c0/c1 u32 word
    arrays (broadcastable).  Returns (x0, x1) int64 tensors of u32 words on
    the counters' device."""
    c0 = _word(c0)
    dev = c0.device
    return _threefry(_word(key[0], dev), _word(key[1], dev), c0, _word(c1, dev))


def derive_key(base_key, counter: int):
    """Per-step key ``threefry2x32(base_key, counter, 0)`` as two Python ints
    (the node's and ``run_offline``'s per-scan key), computed on Python ints:
    it runs on the host every scan, where tensors would only add overhead."""
    return _threefry(
        int(base_key[0]) & _M32, int(base_key[1]) & _M32, int(counter) & _M32, 0
    )


def uniform_pairs(key, pair_indices, dtype=torch.float32):
    """Uniform [0, 1) pairs for an array of pair counters.

    pair_indices: integer tensor [...] of counter values.  Returns (u_lo,
    u_hi), two ``dtype`` tensors shaped like ``pair_indices``."""
    ctr = _word(pair_indices)
    x0, x1 = threefry2x32(key, ctr, torch.zeros_like(ctr))
    u0 = (x0 >> 8).to(dtype) * U01_SCALE
    u1 = (x1 >> 8).to(dtype) * U01_SCALE
    return u0, u1


def pso_init_pairs(population: int, device=None):
    """Pair counters for gbest init ([3]) and population init ([P, 3])."""
    gbest = torch.arange(3, dtype=torch.int64, device=device)
    pop = 3 + torch.arange(population * 3, dtype=torch.int64, device=device)
    return gbest, pop.reshape(population, 3)


def pso_iter_pair_base(population: int) -> int:
    """First pair counter of iteration 0."""
    return 3 + population * 3


def pso_iter_pairs(i, population: int, device=None, count=None):
    """Pair counters for iteration i: [P, 3] (each yields (r1, r2)); with
    ``count``, those of iterations i .. i + count - 1: [count, P, 3]."""
    base = pso_iter_pair_base(population) + i * population * 3
    offs = torch.arange((count or 1) * population * 3, dtype=torch.int64, device=device)
    pairs = (base + offs) & _M32
    return pairs.reshape(population, 3) if count is None else pairs.reshape(count, population, 3)


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m, x):
    """(hi, lo) words of the 64-bit product of the u32 words m and x.

    The product reaches 2^64 and would overflow an int64 lane, so x is split
    into 16-bit halves: no partial sum reaches 2^49, and the result is exact
    on Python ints and int64 tensors alike."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    s = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (s >> 32), s & _M32


def _philox(k0, k1, c0, c1, c2, c3):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_10) on u32
    words held as Python ints or int64 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox4x32(key, c0, c1, c2, c3):
    """Philox4x32-10.  key: (k0, k1) u32 words; c0..c3 u32 word arrays
    (broadcastable).  Returns four int64 tensors of u32 words on c0's
    device."""
    c0 = _word(c0)
    dev = c0.device
    w = lambda v: _word(v, dev)
    return _philox(w(key[0]), w(key[1]), c0, w(c1), w(c2), w(c3))


# Philox counter layout of a PSO solve (turbo modes).  Each counter yields
# four words; words 0..2 drive dimensions x, y, theta and word 3 is unused.
PHILOX_INIT = 0  # counter (j, 0, PHILOX_INIT, 0): particle j's initial position
PHILOX_SEED = 1  # counter (0, 0, PHILOX_SEED, 0): the global-best seed's jitter
PHILOX_R1 = 0  # counter (j, i + 1, PHILOX_R1, 0): iteration i, particle j, r1
PHILOX_R2 = 1  # counter (j, i + 1, PHILOX_R2, 0): iteration i, particle j, r2


def philox_uniforms(key, particle, step, select, dtype=torch.float32):
    """Uniforms [..., 3] in [0, 1) from the counters (particle, step, select,
    0), broadcast over the argument shapes.

    The PSO layout (``rng_mode="native"``): ``step`` is 0 at init and i + 1 in
    iteration i; ``select`` picks the draw (``PHILOX_*`` above).  Words 0..2
    become the uniforms ``(bits >> 8) * 2^-24``, as in the Threefry stream."""
    particle = _word(particle)
    x = philox4x32(key, particle, step, select, 0)
    shape = torch.broadcast_shapes(*(v.shape for v in x))
    words = torch.stack([v.expand(shape) for v in x[:3]], dim=-1)
    return (words >> 8).to(dtype) * U01_SCALE
