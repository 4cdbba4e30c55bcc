"""The port's variant studies (ndtpso_slam_tpu_torch/experiments/ and the
kernels' modules ops/score_variants.py, ops/row_scatter.py) against the TPU
studies under experiments/, on the CPU.

The TPU scripts' own Pallas kernels run in interpret mode (loaded by path;
their ``main()`` is guarded), at small shapes; ``experiments/pallas_variants.py``
runs its work at import, so its ``xla_baseline`` is rebuilt from the JAX
package.  Tolerances, with their reasons:

* f32 and bf16 z routes with the reduction on the cores: rtol 1e-5 /
  atol 1e-5 — the same roundings, sums in another order;
* a reduction on the tensor cores (``mma``): the port rounds each score to
  TF32 (bf16 on the bf16 route), the TPU script's interpreted kernel does
  not; every term is >= 0, so that rounding moves the sum by at most its
  relative half ulp: rtol 2^-11 (TF32) or 2^-8 (bf16), plus 1e-5;
* the score block's bf16all: the bf16 exp2 of XLA and of PyTorch may round
  a score to neighbouring bf16 values: rtol 2^-7 (one bf16 ulp of every
  term) and atol 0.05 (a max(z, 0) that lands on the other side of a bf16
  rounding moves one score by at most ~1.5e-3);
* whole solves: tests/test_torch_batch.py's frozen-solve tolerance, costs
  rtol 1e-4 / atol 1e-3 and poses atol 5e-3;
* the row scatter: bit for bit.

The kernels run only on a GPU: the ``gpu``-marked tests compare each with its
plain version there and skip here.  The GPU machine has no JAX, so run them
there with ``python -m pytest --noconftest -m gpu tests/test_torch_experiments.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch.experiments import kernel_variants as tkv
from ndtpso_slam_tpu_torch.experiments import pallas_variants as tpv
from ndtpso_slam_tpu_torch.experiments import rollout_score_variants as trs
from ndtpso_slam_tpu_torch.experiments import scatter_unique_ab as tsu
from ndtpso_slam_tpu_torch.ops import row_scatter as trow
from ndtpso_slam_tpu_torch.ops import score_variants as tsv

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from ndtpso_slam_tpu import config as jcfg
    from ndtpso_slam_tpu.models import cost as jcost
    from ndtpso_slam_tpu.models import ndt_map as jmap
    from ndtpso_slam_tpu.models.pso import pso_solve_batch as jpso_solve_batch
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (the TPU studies and the reference)")

ROOT = Path(__file__).resolve().parent.parent
TF32_U = 2.0**-11
BF16_U = 2.0**-8


def _load(name):
    """A TPU study under experiments/, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"tpu_study_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def e1():
    return _load("kernel_variants")


@pytest.fixture(scope="module")
def e3():
    return _load("rollout_score_variants")


@pytest.fixture(scope="module")
def e4():
    return _load("scatter_unique_ab")


def _small(b=2, f=16, p=256, n=32, seed=3):
    rs = np.random.RandomState(seed)
    phit = rs.uniform(-1, 1, (b, f, p)).astype(np.float32)
    w = rs.uniform(0, 1, (b, n, f)).astype(np.float32)
    mask = (rs.uniform(0, 1, (b, n)) > 0.2).astype(np.float32)
    return phit, w, mask


# ------------------------------------------------------------- shapes kept


@needs_jax
def test_studies_keep_the_tpu_shapes(e1, e3, e4):
    assert (tkv.B, tkv.P, tkv.N, tkv.I, tkv.FDIM, tkv.TILE_P) == (e1.B, e1.P, e1.N, e1.I, e1.FDIM, e1.TILE_P)
    assert (trs.B, trs.P, trs.N, trs.I, trs.FDIM) == (e3.B, e3.P, e3.N, e3.I, e3.FDIM)
    assert (tsu.B, tsu.C, tsu.M, tsu.R, tsu.W, tsu.REPS, tsu.SCAN_T) == (
        e4.B, e4.C, e4.M, e4.R, e4.W, e4.REPS, e4.SCAN_T)
    assert trs.VARIANTS == ("base", "exp2", "noclamp", "bf16mm", "bf16all")
    assert len(tkv.CONFIGS) == 6 and {t for *_, t in tkv.CONFIGS} == {2048, 4096}


def test_bf16_constant_is_the_rounded_log2e_half():
    half = torch.tensor([tsv.LOG2E_HALF], dtype=torch.float32)
    assert tsv.bf16_round(half).item() == tsv.LOG2E_HALF_BF16


def test_tf32_round_keeps_ten_mantissa_bits_ties_away():
    ulp = 2.0**-10
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4, 1.0 + 3 * ulp / 4,
                      float("inf"), float("-inf")], dtype=torch.float32)
    want = [1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, float("inf"), float("-inf")]
    assert tsv.tf32_round(x).tolist() == want
    assert torch.isnan(tsv.tf32_round(torch.tensor([float("nan")]))).all()


# -------------------------------------------------- E1: kernel_variants.py


def _e1_jax(mod, zdtype, vpu_reduce, tile, phit, w, mask):
    """The script's own kernel (make_kernel) with its GridSpec, interpreted."""
    b, f, p = phit.shape
    n = w.shape[1]
    return pl.pallas_call(
        mod.make_kernel(zdtype, vpu_reduce),
        out_shape=jax.ShapeDtypeStruct((b, 1, p), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(b, p // tile),
            in_specs=[
                pl.BlockSpec((1, n, f), lambda i, j: (i, 0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, f, tile), lambda i, j: (i, 0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1, n), lambda i, j: (i, 0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, 1, tile), lambda i, j: (i, 0, j), memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(w, phit, mask[:, None, :])


E1_PAIRS = [("f32", "mma"), ("bf16", "mma"), ("f32", "cores"), ("bf16", "cores")]


@needs_jax
@pytest.mark.parametrize("zroute,reduce", E1_PAIRS)
def test_e1_plain_matches_the_tpu_kernel(e1, zroute, reduce):
    phit, w, mask = _small()
    zdtype = jnp.bfloat16 if zroute == "bf16" else jnp.float32
    want = np.asarray(_e1_jax(e1, zdtype, reduce == "cores", 128, jnp.asarray(phit),
                              jnp.asarray(w), jnp.asarray(mask)))
    got = tkv.scores(*(torch.from_numpy(a) for a in (phit, w, mask)), zroute, reduce, 128).numpy()
    assert got.shape == want.shape == (2, 1, 256)
    rtol = 1e-5 + ((BF16_U if zroute == "bf16" else TF32_U) if reduce == "mma" else 0.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


def test_e1_study_runs_every_configuration_on_the_cpu():
    res = tkv.run(torch.device("cpu"), b=2, p=64, n=32, iters=2)
    assert list(res) == [name for name, *_ in tkv.CONFIGS]
    for name, (out, diff, ms) in res.items():
        assert out.shape == (2, 1, 64) and torch.isfinite(out).all() and ms > 0
    # bf16 operands against v0's f32: a few bf16 ulps of each term.
    assert max(diff for _, diff, _ in res.values()) < 0.5


@pytest.mark.parametrize("zroute,reduce", [("f32", "cores"), ("bf16", "mma"), ("tf32", "mma"),
                                           ("outer", "cores")])
def test_score_variants_pad_15_features_to_16(zroute, reduce):
    """15 features are the zero-padded 16, and a strided phi [B, 15, P]
    (features of a particle-major array) gives the same costs."""
    phit, w, mask = (torch.from_numpy(a) for a in _small(f=15, p=48))
    a = tsv.score_variants(phit, w, mask, zroute, reduce)
    b = tsv.score_variants(phit.transpose(1, 2).contiguous().transpose(1, 2), w, mask, zroute, reduce)
    pad = lambda x, d: torch.cat([x, torch.zeros_like(x.narrow(d, 0, 1))], d)
    c = tsv.score_variants(pad(phit, 1), pad(w, 2), mask, zroute, reduce)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_score_variants_keep_nan_and_reject_bad_variants():
    phit, w, mask = (torch.from_numpy(a) for a in _small(p=32))
    w[0, 3, 2] = float("nan")
    out = tsv.score_variants(phit, w, mask, "f32", "cores")
    assert torch.isnan(out[0]).all() and torch.isfinite(out[1]).all()
    with pytest.raises(ValueError, match="outer"):
        tsv.score_variants(phit, w, mask, "outer", "mma")
    with pytest.raises(ValueError, match="unknown"):
        tsv.score_variants(phit, w, mask, "fp8", "cores")


def test_outer_route_is_the_unfused_feature_loop():
    """The outer route's z is the sequential sum of rounded products."""
    phit, w, mask = (torch.from_numpy(a) for a in _small(p=16, n=8))
    z = torch.zeros(2, 8, 16)
    for f in range(16):
        z = z + w[:, :, f, None] * phit[:, None, f, :]
    want = -(mask[:, None, :] @ torch.exp(-0.5 * torch.clamp(z, min=0.0)))[:, 0, :]
    assert torch.equal(tsv.score_variants(phit, w, mask, "outer", "cores"), want)


# ------------------------------------------- E3: rollout_score_variants.py

E3_ITERS = 3


def _e3_jax(mod, variant, phit, w):
    """The script's own kernel (make_kernel) with its GridSpec, interpreted;
    the module global I is set small (the kernel reads it at trace time)."""
    b, f, p = phit.shape
    n = w.shape[1]
    mod.I = E3_ITERS
    return pl.pallas_call(
        mod.make_kernel(variant),
        out_shape=jax.ShapeDtypeStruct((b, 8, 128), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(b,),
            in_specs=[pl.BlockSpec((1, n, f), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                      pl.BlockSpec((1, f, p), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(w, phit)


def _e3_chain(variant, phit, w, iters):
    """A transcription in jnp of the script's per-iteration chain
    (experiments/rollout_score_variants.py:25-47), batched over solves;
    returns (carry [B], the last iteration's c [B, P])."""
    log2e_half = 0.7213475204444817
    carry = jnp.zeros(phit.shape[0], jnp.float32)
    c = None
    for _ in range(iters):
        pv = phit * (1.0 + carry * 0.0)[:, None, None]
        if variant in ("bf16mm", "bf16all"):
            z = jnp.einsum("bnf,bfp->bnp", w.astype(jnp.bfloat16), pv.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
        else:
            z = jnp.einsum("bnf,bfp->bnp", w, pv, precision=jax.lax.Precision.HIGHEST)
        if variant == "exp2":
            s = jnp.exp2(-log2e_half * jnp.maximum(z, 0.0))
        elif variant == "noclamp":
            s = jnp.exp(-0.5 * z)
        elif variant == "bf16all":
            zb = jnp.maximum(z, 0.0).astype(jnp.bfloat16)
            s = jnp.exp2(jnp.bfloat16(-log2e_half) * zb).astype(jnp.float32)
        else:
            s = jnp.exp(-0.5 * jnp.maximum(z, 0.0))
        c = -jnp.sum(s, axis=1)
        carry = carry + jnp.min(c, axis=1) * 0.0
    return np.asarray(carry), np.asarray(c)


E3_TOL = {"bf16all": dict(rtol=2.0**-7, atol=0.05)}


@needs_jax
@pytest.mark.parametrize("variant", tsv.BLOCK_VARIANTS)
def test_e3_plain_matches_the_tpu_kernel_and_its_chain(e3, variant):
    phit, w, _ = _small(n=32, p=128)
    phit[1, 4, 7] = np.nan  # solve 1's carry turns NaN, solve 0's stays 0
    jcarry = np.asarray(_e3_jax(e3, variant, jnp.asarray(phit), jnp.asarray(w)))
    carry, c = tsv.score_block(torch.from_numpy(phit), torch.from_numpy(w), E3_ITERS, variant)
    np.testing.assert_array_equal(carry.numpy(), jcarry[:, 0, 0])
    assert carry[0] == 0 and torch.isnan(carry[1])
    ccarry, cc = _e3_chain(variant, jnp.asarray(phit), jnp.asarray(w), E3_ITERS)
    np.testing.assert_array_equal(carry.numpy(), ccarry)
    np.testing.assert_allclose(c.numpy(), cc, **E3_TOL.get(variant, dict(rtol=1e-5, atol=1e-5)))


def test_e3_study_runs_every_variant_on_the_cpu():
    res = trs.run(torch.device("cpu"), b=2, p=64, n=32, iters=2)
    assert list(res) == list(trs.VARIANTS)
    for carry, c, ms, ms_half in res.values():
        assert (carry == 0).all() and c.shape == (2, 64) and torch.isfinite(c).all()


# ------------------------------------------------- E2: pallas_variants.py

E2_B, E2_P, E2_I = 2, 64, 4
JMAP = None if jax is None else jcfg.MapConfig(size_m=64.0, cell_side_m=1.0, window_slots=4)


@pytest.fixture(scope="module")
def e2_world():
    return tpv.world(torch.device("cpu"), b=E2_B, population=E2_P, iterations=E2_I)


def _tf32_jnp(x):
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    r = jax.lax.bitcast_convert_type((bits + 0x1000) & ~0x1FFF, jnp.float32)
    return jnp.where(jnp.isfinite(x), r, x)


def _e2_jax_solve(wd, zround=None, sround=None):
    """The script's xla_baseline (pallas_variants.py:95-97) from the JAX
    package, with optional roundings of the z operands and of the scores
    and mask (the port's TF32 routes)."""
    snaps = jmap.MapSnapshot(**{k: jnp.asarray(getattr(wd["snaps"], k).numpy())
                                for k in ("mean", "inv_cov", "built")})
    points, valid = jnp.asarray(wd["points"].numpy()), jnp.asarray(wd["valid"].numpy())
    cfg = jcfg.PSOConfig(iterations=E2_I, population=E2_P)

    def cost_fn(poses, binds):
        bound = jax.vmap(lambda b_, s, p, v: jcost.bind_points(b_, s, p, v, JMAP))(
            binds, snaps, points, valid)
        phi, w, mask = jcost.pose_features(poses, bound.bind_pose), bound.w, bound.mask
        if zround:
            phi, w = zround(phi), zround(w)
        z = jnp.einsum("bpf,bnf->bpn", phi, w, precision=jax.lax.Precision.HIGHEST)
        s = jnp.exp(-0.5 * jnp.maximum(z, 0.0))
        if sround:
            s, mask = sround(s), sround(mask)
        return -jnp.einsum("bpn,bn->bp", s, mask, precision=jax.lax.Precision.HIGHEST)

    keys = jnp.asarray(wd["keys"].numpy().astype(np.uint32))
    res = jax.jit(lambda k, g, d: jpso_solve_batch(k, g, d, cost_fn, cfg))(
        keys, jnp.asarray(wd["guesses"].numpy()), jnp.asarray(wd["devs"].numpy()))
    return np.asarray(res.pose), np.asarray(res.cost)


@needs_jax
@pytest.mark.parametrize("name", [tpv.BASELINE, *tpv.VARIANTS])
def test_e2_solver_matches_the_jax_baseline(e2_world, name):
    """Each variant's plain version inside the port's batched solver against
    the script's xla_baseline, with the variant's roundings applied on the
    JAX side too (TF32 operands; TF32 scores and mask for dot_dot)."""
    if name == tpv.BASELINE:
        cost_fn, rounds = tpv.baseline_cost(e2_world), {}
    else:
        zroute, reduce = tpv.VARIANTS[name]
        cost_fn = tpv.variant_cost(e2_world, zroute, reduce, 256)
        rounds = dict(zround=_tf32_jnp if zroute == "tf32" else None,
                      sround=_tf32_jnp if reduce == "mma" else None)
    res = tpv.solve(e2_world, cost_fn)
    jpose, jcost_ = _e2_jax_solve(e2_world, **rounds)
    np.testing.assert_allclose(res.cost.numpy(), jcost_, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(res.pose.numpy(), jpose, atol=5e-3)


def test_e2_study_runs_every_variant_on_the_cpu():
    res = tpv.run(torch.device("cpu"), b=2, n=96, population=32, iterations=2, reps=1)
    assert list(res) == [tpv.BASELINE] + [f"{v}_t{t}" for v in tpv.VARIANTS for t in tpv.TILES]
    assert res[tpv.BASELINE]["maxdiff"] == 0.0
    for r in res.values():
        assert r["pose"].shape == (2, 3) and torch.isfinite(r["cost"]).all()


# ----------------------------------------------- E4: scatter_unique_ab.py


def _jax_set(rows, width, fid, vals):
    """The script's reference (scatter_unique_ab.py:241-245)."""
    return np.asarray(jnp.zeros((rows, width), jnp.float32).at[jnp.asarray(fid)].set(jnp.asarray(vals)))


@needs_jax
@pytest.mark.parametrize("n_fields", [1, 3])
@pytest.mark.parametrize("width", [2, 128])
def test_e4_unique_ids_equal_the_script_reference(e4, n_fields, width):
    """Unique ids, and dropped ids sent to the junk row R: the real rows
    bit-equal to the script's reference; the junk row holds one of the
    rows aimed at it."""
    rs = np.random.RandomState(width + n_fields)
    r, m = 300, 40
    fid = rs.permutation(r)[:m].astype(np.int64)
    fid[::7] = r  # dropped
    vals = [rs.randn(m, width).astype(np.float32) for _ in range(n_fields)]
    ops = [torch.zeros((r + 1, width)) for _ in range(n_fields)]
    got = trow.row_scatter(ops, torch.from_numpy(fid), [torch.from_numpy(v) for v in vals])
    for op, v in zip(got, vals):
        want = _jax_set(r + 1, width, fid, v)
        np.testing.assert_array_equal(op.numpy()[:r], want[:r])
        assert any(np.array_equal(op.numpy()[r], v[i]) for i in np.flatnonzero(fid == r))


@needs_jax
def test_e4_duplicate_ids_leave_one_of_the_rows(e4):
    """The script's duplicate-laden id stream at a small size: every written
    row equals one of the rows aimed at it, every other row is unchanged,
    and rows hit once equal the script's reference."""
    ids, rs = tsu.fleet_ids(b=2, c=500, m=512)
    assert len(np.unique(ids)) < len(ids)
    vals = rs.randn(len(ids), 2).astype(np.float32)
    before = torch.from_numpy(rs.randn(1001, 2).astype(np.float32))
    got = trow.row_scatter([before.clone()], torch.from_numpy(ids), [torch.from_numpy(vals)])[0]
    out = got.numpy()
    for t in np.unique(ids):
        assert any(np.array_equal(out[t], vals[i]) for i in np.flatnonzero(ids == t))
    untouched = np.setdiff1d(np.arange(1001), ids)
    np.testing.assert_array_equal(out[untouched], before.numpy()[untouched])
    once = [t for t in np.unique(ids) if (ids == t).sum() == 1]
    np.testing.assert_array_equal(out[once], _jax_set(1001, 2, ids, vals)[once])
    assert tsu.duplicate_rule(before, got, torch.from_numpy(ids), torch.from_numpy(vals))


def test_row_scatter_drops_out_of_range_ids_and_takes_the_last_duplicate():
    op = torch.zeros(4, 2)
    idx = torch.tensor([1, -1, 4, 1, 2])
    vals = torch.arange(10, dtype=torch.float32).view(5, 2)
    trow.row_scatter([op], idx, [vals])
    assert op.tolist() == [[0, 0], [6, 7], [8, 9], [0, 0]]
    with pytest.raises(ValueError, match="1-3 fields"):
        trow.row_scatter([op] * 4, idx, [vals] * 4)


def test_row_scatter_rejects_rows_past_int32():
    """The kernel keys its claim table on int32 ids, so an operand may have
    at most 2^31 - 1 rows; ids 2^32 apart would otherwise share a key."""
    huge = torch.zeros(1, 2).expand(trow.MAX_ROWS + 1, 2)
    with pytest.raises(ValueError, match="int32"):
        trow.row_scatter([huge], torch.tensor([0, 2**32]), [torch.zeros(2, 2)])


@pytest.mark.parametrize("m,slots,blocks", [(1, 2, 1), (100, 256, 1), (12_288, 32_768, 128),
                                            (65_536, 131_072, 512),
                                            (1_000_000, 2_097_152, 8_192)])
def test_row_scatter_table_and_grid_by_m(m, slots, blocks):
    """The claim table's slots (the least power of two >= 2 M) and the blocks
    the launch asks for (a thread per slot; the kernel caps them at what the
    card holds at once, and its loops stride the grid)."""
    assert trow.table_slots(m) == slots and trow.grid_blocks(m) == blocks


def test_e4_study_runs_on_the_cpu():
    res = tsu.run(torch.device("cpu"), b=2, c=500, m=256, reps=1)
    assert res["correct"] and res["duplicate_rule"]
    assert res["correct_w128"] and res["duplicate_rule_w128"]
    assert {"row_scatter", "row_scatter_3", "index_copy", "index_put", "index_copy_sorted",
            "index_copy_unique", "prep_sorted", "prep_unique", "gather", "scan_row_scatter",
            "scan_index_copy", "row_scatter_w128", "index_copy_w128"} <= set(res)


@pytest.mark.parametrize("module", [tkv, trs, tpv, tsu])
def test_entry_points_default_to_cuda(module):
    """Without --device cpu an entry point asks for the CUDA device, which
    raises on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        module.main([])


# ------------------------------------------------ the kernels, on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


# (rtol, atol) of a kernel against its plain version: sum order (f32, as
# the scoring kernel's own test), and where a score is rounded, up to
# _FLIPS terms whose score lands on the neighbouring value, each moving the
# cost by one ulp of a score <= 1 with a 0/1 mask: 2^-11 (TF32), 2^-8
# (bf16), 2^-7 (bf16all, whose max(z, 0), exponent and score are rounded).
_FLIPS = 4
_GPU_TOL = {"cores": (1e-5, 1e-4), ("mma", "bf16"): (1e-5, 1e-4 + _FLIPS * BF16_U),
            ("mma", "tf32"): (1e-5, 1e-4 + _FLIPS * TF32_U), "bf16all": (1e-5, 1e-4 + _FLIPS * 2 * BF16_U)}


_GPU_VARIANTS = [(z, r) for z in tsv.ZROUTES for r in tsv.REDUCES if (z, r) != ("outer", "mma")]


@pytest.mark.gpu
@pytest.mark.parametrize("zroute,reduce", _GPU_VARIANTS)
@pytest.mark.parametrize("tile", [16, 64, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("p,n", [(300, 100), (4095, 383), (17, 9)])
def test_score_variant_kernel_matches_plain_on_gpu(cuda_device, zroute, reduce, tile, p, n):
    """Every route at every tile (E2's and E1's, and below a warp's
    particles), ragged P and N, 15 features; a NaN in one w row makes the
    solve's costs NaN."""
    phit, w, mask = (torch.from_numpy(a).to(cuda_device) for a in _small(b=3, f=15, p=p, n=n))
    w[2, n // 2, 3] = float("nan")
    before = tsv.score_variants.LAUNCHES
    got = tsv.score_variants(phit, w, mask, zroute, reduce, tile)
    torch.cuda.synchronize()
    assert tsv.score_variants.LAUNCHES == before + 1
    ref = tsv.score_variants_reference(phit, w, mask, zroute, reduce)
    key = "cores" if reduce == "cores" else ("mma", "bf16" if zroute == "bf16" else "tf32")
    rtol, atol = _GPU_TOL[key]
    assert torch.isnan(got[2]).all() and torch.isnan(ref[2]).all()
    np.testing.assert_allclose(got[:2].cpu().numpy(), ref[:2].cpu().numpy(), rtol=rtol, atol=atol)


def _chosen_cluster(phit, w, variant):
    """The cluster size ops/_build.py:choose_cluster picks for this launch,
    from the card's own occupancy query."""
    from ndtpso_slam_tpu_torch.ops import _build

    lib = _build.load(tsv.LIB)
    vidx = tsv.BLOCK_VARIANTS.index(variant)
    n = w.shape[1]
    smem = lib.ndt_score_block_smem_bytes(n, vidx)
    limit = _build.device_limits(torch.cuda.current_device())[0]
    return _build.choose_cluster(phit.shape[0], lambda _c: smem, limit,
                                 lambda c: tsv._block_clusters_held(lib, n, vidx, c, phit.device))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", tsv.BLOCK_VARIANTS)
@pytest.mark.parametrize("b,p,n", [(3, 300, 100), (65, 4095, 383), (3, 17, 384), (2, 4096, 16)])
def test_score_block_kernel_matches_plain_on_gpu(cuda_device, variant, b, p, n):
    """One solve per cluster at the chooser's C, B not a multiple of the
    card's clusters, ragged P and N; a NaN in one phi turns the last solve's
    carry NaN as the plain version's does, the others stay 0."""
    phit, w, _ = (torch.from_numpy(a).to(cuda_device) for a in _small(b=b, p=p, n=n))
    phit[b - 1, 1, p // 2] = float("nan")
    before = tsv.score_block.LAUNCHES
    carry, c = tsv.score_block(phit, w, 4, variant)
    rcarry, rc = tsv.score_block_reference(phit, w, 4, variant)
    torch.cuda.synchronize()
    assert tsv.score_block.LAUNCHES == before + 1
    assert tsv.score_block.LAST["cluster"] == _chosen_cluster(phit, w, variant)
    assert tsv.score_block.LAST["ctas"] == b * tsv.score_block.LAST["cluster"]
    assert carry[:-1].tolist() == [0.0] * (b - 1) and torch.equal(carry[:-1], rcarry[:-1])
    assert torch.isnan(carry[-1]) and torch.isnan(rcarry[-1])
    assert torch.isnan(c[-1]).all() and torch.isnan(rc[-1]).all()
    rtol, atol = _GPU_TOL["bf16all" if variant == "bf16all" else "cores"]
    np.testing.assert_allclose(c[:-1].cpu().numpy(), rc[:-1].cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", tsv.BLOCK_VARIANTS)
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_score_block_kernel_at_every_cluster_size_on_gpu(cuda_device, variant, cluster):
    """A forced C splits the particles differently but leaves every
    particle's sum whole: the same results at C = 1, 2, 4, 8, and the
    iterations still tie through the cluster's minimum (a NaN carry)."""
    phit, w, _ = (torch.from_numpy(a).to(cuda_device) for a in _small(b=3, p=1000, n=100))
    phit[1, 2, 999] = float("nan")
    carry, c = tsv.score_block(phit, w, 3, variant, cluster=cluster)
    rcarry, rc = tsv.score_block_reference(phit, w, 3, variant)
    torch.cuda.synchronize()
    assert tsv.score_block.LAST["cluster"] == cluster
    assert carry[0] == 0 and carry[2] == 0 and torch.isnan(carry[1]) and torch.isnan(rcarry[1])
    rtol, atol = _GPU_TOL["bf16all" if variant == "bf16all" else "cores"]
    np.testing.assert_allclose(c[[0, 2]].cpu().numpy(), rc[[0, 2]].cpu().numpy(), rtol=rtol,
                               atol=atol)
    sms, ctas = tsv.block_sms(phit, w, 1, variant, cluster=cluster)
    assert ctas == 3 * cluster and 1 <= sms <= ctas


@pytest.mark.gpu
@pytest.mark.parametrize("n_fields", [1, 2, 3])
@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 33, 128, 129])
def test_row_scatter_kernel_matches_plain_on_gpu(cuda_device, n_fields, width):
    """Bit-equal to the plain version, duplicates and dropped ids included,
    and to index_copy_ on unique ids."""
    ids, rs = tsu.fleet_ids(b=2, c=5000, m=2048)
    ids[::97] = -1
    idx = torch.from_numpy(ids).to(cuda_device)
    vals = [torch.from_numpy(rs.randn(len(ids), width).astype(np.float32)).to(cuda_device)
            for _ in range(n_fields)]
    base = torch.from_numpy(rs.randn(10001, width).astype(np.float32)).to(cuda_device)
    got = trow.row_scatter([base.clone() for _ in range(n_fields)], idx, vals)
    want = trow.row_scatter_reference([base.clone() for _ in range(n_fields)], idx, vals)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)
    targets, rows = trow.winners(idx, 10001)
    got = trow.row_scatter([base.clone()], targets, [vals[0][rows]])[0]
    assert torch.equal(got, base.clone().index_copy_(0, targets, vals[0][rows]))


def _scatter_case(device, m, rows, width, n_fields=1, seed=0, offset=0):
    """ids [m] over [-2, rows + 2) and the operands and vals, on device;
    offset > 0 starts every operand and vals that many floats into its
    storage (rows no longer aligned to 8 or 16 bytes)."""
    rs = np.random.RandomState(seed)
    idx = torch.from_numpy(rs.randint(-2, rows + 2, m)).to(device)

    def placed(a):
        flat = torch.zeros(a.size + offset, dtype=torch.float32, device=device)
        flat[offset:] = torch.from_numpy(a.reshape(-1)).to(device)
        return flat[offset:].view(a.shape)

    base = rs.randn(rows, width).astype(np.float32)
    vals = [placed(rs.randn(m, width).astype(np.float32)) for _ in range(n_fields)]
    return idx, [placed(base) for _ in range(n_fields)], vals


def _scatter_equal(ops, idx, vals):
    """row_scatter on copies of ops bit-equal to the plain version, in one
    launch."""
    before = trow.row_scatter.LAUNCHES
    got = trow.row_scatter([op.clone() for op in ops], idx, vals)
    assert trow.row_scatter.LAUNCHES == before + 1
    want = trow.row_scatter_reference([op.clone() for op in ops], idx, vals)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [2, 4, 5, 128])
def test_row_scatter_misaligned_rows_on_gpu(cuda_device, width):
    """Operands and vals one float into their storage: the kernel takes the
    vector width their alignment allows."""
    idx, ops, vals = _scatter_case(cuda_device, 3000, 1000, width, n_fields=3, offset=1)
    assert ops[0].data_ptr() % 8 == 4
    _scatter_equal(ops, idx, vals)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [2, 128])
@pytest.mark.parametrize("m", [65_536, 1_000_000])
def test_row_scatter_beyond_one_thread_per_slot_on_gpu(cuda_device, m, width):
    """M whose table asks for more blocks than the card holds at once (from
    M = 65,536 at W=128, where the kernel's registers allow fewer blocks
    per SM): the grid is capped and every phase strides it."""
    idx, ops, vals = _scatter_case(cuda_device, m, 2 * m if width == 2 else 20_000, width, seed=3)
    _scatter_equal(ops, idx, vals)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [12_288, 300_000])
@pytest.mark.parametrize("stream", ["one_row", "out_of_range"])
def test_row_scatter_degenerate_id_streams_on_gpu(cuda_device, stream, m):
    """Every id aimed at one row (the last update row wins), and every id
    out of range (nothing written)."""
    _, ops, vals = _scatter_case(cuda_device, m, 1000, 3)
    if stream == "one_row":
        idx = torch.full((m,), 7, dtype=torch.int64, device=cuda_device)
    else:
        idx = torch.tensor([-1, 1000, 2**40], device=cuda_device).repeat(m // 3 + 1)[:m]
    got = trow.row_scatter([ops[0].clone()], idx, vals)[0]
    torch.cuda.synchronize()
    want = ops[0].clone()
    if stream == "one_row":
        want[7] = vals[0][-1]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_row_scatter_no_update_rows_on_gpu(cuda_device):
    """M = 0: no launch, nothing written."""
    _, ops, _ = _scatter_case(cuda_device, 1, 100, 2)
    before = trow.row_scatter.LAUNCHES
    got = trow.row_scatter([ops[0].clone()], torch.zeros(0, dtype=torch.int64, device=cuda_device),
                           [torch.zeros((0, 2), device=cuda_device)])[0]
    assert trow.row_scatter.LAUNCHES == before and torch.equal(got, ops[0])


@pytest.mark.gpu
@pytest.mark.parametrize("m1,m2", [(12_288, 300_000), (300_000, 12_288)])
def test_row_scatter_calls_in_a_row_on_gpu(cuda_device, m1, m2):
    """Two calls on different id streams into the same operands, the second
    smaller or larger than the first (so the stream's table grows): the
    second sees nothing of the first's claims."""
    idx1, ops, vals1 = _scatter_case(cuda_device, m1, 5000, 2, seed=1)
    idx2, _, vals2 = _scatter_case(cuda_device, m2, 5000, 2, seed=2)
    got = [op.clone() for op in ops]
    trow.row_scatter(got, idx1, vals1)
    trow.row_scatter(got, idx2, vals2)
    want = trow.row_scatter_reference([op.clone() for op in ops], idx1, vals1)
    trow.row_scatter_reference(want, idx2, vals2)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])


@pytest.mark.gpu
def test_row_scatter_on_two_streams_on_gpu(cuda_device):
    """Calls on two streams at once, each with its own table."""
    cases = [_scatter_case(cuda_device, 50_000, 5000, 2, seed=s) for s in (4, 5)]
    got = [[op.clone() for op in ops] for _, ops, _ in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    for stream, (idx, _, vals), g in zip(streams, cases, got):
        with torch.cuda.stream(stream):
            trow.row_scatter(g, idx, vals)
    torch.cuda.synchronize()
    for (idx, ops, vals), g in zip(cases, got):
        want = trow.row_scatter_reference([op.clone() for op in ops], idx, vals)
        assert torch.equal(g[0], want[0])
