"""The launch geometry, the -w/2 staging and the sum orders of the scoring
studies' kernels (ndtpso_slam_tpu_torch/csrc/score_variants.cu), on the CPU.

The kernels run only on a GPU (tests/test_torch_experiments.py holds them to
their plain versions there).  What their results rest on is checked here:

* E3's launch geometry (one solve per cluster of C CTAs, split over
  particles) as the pure function ``score_variants.block_launch``;
* staging w as -w/2 is exact per route, so a kernel's z' is the plain
  version's -z/2 bit for bit (a subnormal w aside: one subnormal step);
* float32 twins of the sum orders the kernels now take (each particle's
  points in order in one thread; E1's f32 route with the reduction on the
  tensor cores, groups of 8 points), held to the unchanged tolerances of
  chip_smoke.py (VARIANT_TOL: rtol 1e-5, atol 1e-4; TF32 reductions atol
  1e-4 + 4 * 2^-11).
"""

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch.experiments import kernel_variants as tkv
from ndtpso_slam_tpu_torch.experiments import rollout_score_variants as trs
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops import score_variants as tsv

SMS = 132  # an H100
SMEM_LIMIT = 232448
F32_SMEM = 384 * 16 * 4  # E3's f32 CTA: the solve's w
CORES_TOL = dict(rtol=1e-5, atol=1e-4)
TF32_TOL = dict(rtol=1e-5, atol=1e-4 + 4 * 2.0**-11)


def _held(ctas_per_sm):
    """Clusters of C the card holds at once, ctas_per_sm CTAs on each SM."""
    return lambda c: SMS * ctas_per_sm // c


# --------------------------------------------------------- E3's geometry


@pytest.mark.parametrize("batch,population,per_sm,want", [
    (64, 4096, 1, dict(cluster=2, ctas=128, per_cta=2048)),
    (64, 4096, 2, dict(cluster=4, ctas=256, per_cta=1024)),
    (1, 4096, 1, dict(cluster=8, ctas=8, per_cta=512)),
    (64, 4095, 1, dict(cluster=2, ctas=128, per_cta=2048)),
    (64, 17, 1, dict(cluster=2, ctas=128, per_cta=9)),
    (3, 17, 1, dict(cluster=8, ctas=24, per_cta=3)),
    (65, 4096, 1, dict(cluster=2, ctas=130, per_cta=2048)),
])
def test_block_launch_geometry(batch, population, per_sm, want):
    """One wave at B=64 (C=2 at one 512-thread CTA per SM: 128 CTAs, 97% of
    the SMs; C=4 at two), the largest C at B=1, and ragged populations."""
    got = tsv.block_launch(batch, population, _held(per_sm), F32_SMEM, SMEM_LIMIT)
    assert got == want
    assert _build.waves(batch, _held(per_sm)(got["cluster"])) == 1
    # Every particle in exactly one CTA's contiguous slice (csrc: particle_slice).
    c, per = got["cluster"], got["per_cta"]
    owned = [j for r in range(c) for j in range(min(population, r * per),
                                                 min(population, min(population, r * per) + per))]
    assert owned == list(range(population))


def test_block_launch_forced_cluster_and_shared_memory():
    assert tsv.block_launch(64, 4096, _held(1), F32_SMEM, SMEM_LIMIT, cluster=8) == dict(
        cluster=8, ctas=512, per_cta=512)
    with pytest.raises(ValueError, match="no cluster size"):
        tsv.block_launch(64, 4096, _held(1), SMEM_LIMIT, SMEM_LIMIT)


# --------------------------------------------------------- -w/2 staging


def _staging_values(seed=5):
    """Seeded float32 values over the whole exponent range, with ±0,
    subnormals (the smallest, random ones, the largest), ±inf and NaN."""
    rs = np.random.RandomState(seed)
    normal = (rs.uniform(-1, 1, 4000) * 2.0 ** rs.randint(-125, 127, 4000)).astype(np.float32)
    sub_bits = rs.randint(1, 1 << 23, 400).astype(np.uint32)
    sub = sub_bits.view(np.float32) * np.where(rs.uniform(size=400) < 0.5, -1, 1).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.4e-45, -1.4e-45,
                        np.float32(2.0**-126) * 0.999, 1.0, -1.0, 3.4e38], np.float32)
    return torch.from_numpy(np.concatenate([normal, sub, special]))


ROUNDINGS = {"tf32": tsv.tf32_round, "bf16": tsv.bf16_round, "f32": lambda x: x}
# The spacing of each route's subnormals: 2^-149 shifted by the dropped bits.
SUBNORMAL_ULP = {"tf32": 2.0**-136, "bf16": 2.0**-133, "f32": 2.0**-149}


@pytest.mark.parametrize("route", list(ROUNDINGS))
def test_half_staging_is_exact(route):
    """rnd(w)·-1/2 == rnd(-w/2), and the halved operand is still an operand
    of the route, for every w but subnormals and the few largest floats
    (whose rounding overflows to inf); a subnormal w moves by at most one
    step of the route's subnormals (2^-136 TF32, 2^-133 bf16, 2^-149 f32),
    which no score can see (a z term is w·φ with |φ| < 1e5)."""
    rnd = ROUNDINGS[route]
    w = _staging_values()
    staged = rnd(w) * -0.5
    other = rnd(-0.5 * w)
    same = (staged == other) | (torch.isnan(staged) & torch.isnan(other))
    normal = (w.abs() >= 2.0**-125) & (w.abs() < 2.0**127)
    assert bool(same[normal | ~torch.isfinite(w) | (w == 0)].all())
    assert bool(torch.equal(rnd(staged)[normal], staged[normal]))
    assert bool(torch.isnan(staged[torch.isnan(w)]).all())
    finite = torch.isfinite(w) & (w.abs() < 2.0**127)
    step = float((staged[finite].double() - other[finite].double()).abs().max())
    assert step <= SUBNORMAL_ULP[route]
    # The halved operand doubles back exactly: no bit of rnd(w) is lost.
    assert bool(torch.equal((staged * -2.0)[finite & normal], rnd(w)[finite & normal]))


@pytest.mark.parametrize("zroute", tsv.HALF_STAGED_ROUTES)
def test_half_staged_z_is_minus_half_z_bit_for_bit(zroute):
    """A product with -w/2 is -1/2 times the product with w, bit for bit,
    on every route the kernels stage so (the outer loop's rounded products
    and sums included), so exp(min(z', 0)) is the plain version's
    exp(-max(z, 0)/2) to the last bit of z."""
    phit, w, _ = tkv.inputs("cpu", b=2, p=64, n=48)
    if zroute == "tf32":
        phit, w = tsv.tf32_round(phit), tsv.tf32_round(w)
    zf = tsv._z_outer if zroute == "outer" else (lambda ph, ww: ww @ ph)
    assert torch.equal(zf(phit, -0.5 * w), -0.5 * zf(phit, w))


def test_staged_variants_are_the_power_of_two_ones():
    """Only scores of the form exp(-max(z, 0)/2) take the staging: exp2's
    -log2(e)/2 and bf16all's bf16 product are not powers of two, and the
    bf16 route and bf16mm multiply z by -1/2."""
    assert tsv.HALF_STAGED_BLOCK == ("base", "noclamp")
    assert not {"exp2", "bf16all", "bf16mm"} & set(tsv.HALF_STAGED_BLOCK)
    assert set(tsv.HALF_STAGED_ROUTES) == {"f32", "tf32", "outer"}
    for c in (tsv.LOG2E_HALF, tsv.LOG2E_HALF_BF16):
        assert np.frexp(c)[0] != 0.5  # not a power of two


# ------------------------------------------------- the kernels' sum orders


def _in_order(s, mask=None):
    """-Σₙ m·s in float32, n = 0..N-1 in order, s [B, N, P]: one thread's
    sum in the register-tile kernels (m·s exact for a 0/1 mask)."""
    acc = torch.zeros((s.shape[0], s.shape[2]), dtype=torch.float32)
    for i in range(s.shape[1]):
        term = s[:, i, :] if mask is None else mask[:, i, None] * s[:, i, :]
        acc = acc + term
    return -acc


def _by_groups_of_8(s, mask):
    """-Σ over groups of 8 points in order, each group's 8 terms summed
    first: variant_kernel_tmma's accumulation (the mma adds one group of 8
    to the running sum per step; its order within a group is the tensor
    core's own, taken here as in order)."""
    b, n, p = s.shape
    acc = torch.zeros((b, p), dtype=torch.float32)
    for k in range(0, n, 8):
        part = torch.zeros((b, p), dtype=torch.float32)
        for i in range(k, min(n, k + 8)):
            part = part + mask[:, i, None] * s[:, i, :]
        acc = acc + part
    return -acc


def _scores(phit, w, zroute="f32"):
    z = tsv._z_outer(phit, w) if zroute == "outer" else w @ phit
    return torch.exp(-0.5 * torch.clamp(z, min=0.0))


@pytest.mark.parametrize("zroute", ["f32", "outer"])
def test_register_tile_order_fits_the_variant_tolerance(zroute):
    """E1's v2 and E2's vpu_outer: each particle's masked sum over N=384
    points in order, against the plain version."""
    phit, w, mask = tkv.inputs("cpu", b=2, p=512)
    want = tsv.score_variants_reference(phit, w, mask, zroute, "cores")
    got = _in_order(_scores(phit, w, zroute), mask)
    torch.testing.assert_close(got, want, **CORES_TOL)


def test_tmma_group_order_fits_the_tf32_tolerance():
    """E1's v0 / v0t: TF32 scores and mask, summed a group of 8 points at a
    time."""
    phit, w, mask = tkv.inputs("cpu", b=2, p=512)
    want = tsv.score_variants_reference(phit, w, mask, "f32", "mma")
    s = tsv.tf32_round(_scores(phit, w))
    got = _by_groups_of_8(s, tsv.tf32_round(mask))
    torch.testing.assert_close(got, want, **TF32_TOL)


@pytest.mark.parametrize("variant", ["base", "exp2", "noclamp"])
def test_block_f32_order_fits_the_variant_tolerance(variant):
    """E3's f32 variants: every particle's sum over N=384 points in order
    in one thread (a CTA holds whole particles), against the plain version's
    last iteration."""
    phit, w = trs.inputs("cpu", b=2, p=512)
    carry, want = tsv.score_block_reference(phit, w, 2, variant)
    got = _in_order(tsv._block_score(w @ phit, variant))
    torch.testing.assert_close(got, want, **CORES_TOL)
    assert torch.equal(carry, torch.zeros(2))
