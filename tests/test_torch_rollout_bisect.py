"""The port's staged rollout kernel (ops/rollout_bisect.py and the entry
point ndtpso_slam_tpu_torch/experiments/rollout_bisect.py) against the TPU
script experiments/rollout_bisect.py, on the CPU.

The TPU script runs a stage when it is imported, so it is loaded through its
syntax tree (test_torch_tpu_scripts.load_script): its imports, constants
and functions, without the top-level stage argument and call (nothing
under experiments/ changes).  Its own
``make_kernel(stage)`` then runs in interpret mode with the script's
GridSpec.  Tolerances, with their reasons:

* the trivial-cost stages (0, 1, 10-19, 21-27): the same Threefry words and
  strict-< decisions, but XLA's CPU code contracts multiply-adds into fused
  multiply-adds — -|pos|^2 becomes a chain of fmas, and so does the PSO
  update — where the port rounds every product, as the kernel does.
  Measured on the script's inputs (seeds 0 and 1) and on binding_inputs:
  bit-equal in stages 0, 10, 12 and 21-27; 1 ulp of the cost in stage 11,
  1 ulp of the best pose and of its cost in stage 1.  The test allows
  ULPS = 1.  On the card, kernel and plain version agree bit for bit;
* stage 20, the seed's rows summed over the population: the sum of P equal
  float32 values in another order (measured: 1 ulp of a pose row, 3 of the
  others), rtol 1e-5;
* stage 2 (a mask sum) and stages 3-9 (the quadratic form): cos/sin/exp of
  XLA-CPU against PyTorch-CPU and sums in another order move a cost and may
  flip a PSO decision between close particles: tests/test_torch_batch.py's
  frozen-solve tolerance, costs rtol 1e-4 / atol 1e-3, poses atol 5e-3.

The kernel runs only on a GPU: the ``gpu``-marked tests compare it with its
plain version there and skip here.  The GPU machine has no JAX, so run them
there with ``python -m pytest --noconftest -m gpu tests/test_torch_rollout_bisect.py``.
"""

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch.experiments import rollout_bisect as trb
from ndtpso_slam_tpu_torch.ops import rollout_bisect as orb

from test_torch_tpu_scripts import load_script

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (the TPU script)")

COST_RTOL, COST_ATOL, POSE_ATOL = 1e-4, 1e-3, 5e-3
ULPS = 1


def ulp_distance(a, b):
    """Largest distance in float32 ulps (steps between neighbouring values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


@pytest.fixture(scope="module")
def e7():
    return load_script("rollout_bisect", drop=("stage",))


def _jax_stage(mod, stage, keys, guesses, devs, pts, sten):
    """The script's kernel for `stage` with its GridSpec (its run()),
    interpreted, on numpy inputs; pts [B, 8, N] with N = the script's N."""
    b = pts.shape[0]
    n, k2 = mod.N, mod.K2
    return np.asarray(pl.pallas_call(
        mod.make_kernel(stage),
        out_shape=jax.ShapeDtypeStruct((b, 8, 128), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(b,),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.SMEM),
                pl.BlockSpec(memory_space=pltpu.SMEM),
                pl.BlockSpec(memory_space=pltpu.SMEM),
                pl.BlockSpec((1, 8, n), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, k2, 8, n), lambda i: (i, 0, 0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(*(jnp.asarray(a) for a in (keys.astype(np.uint32), guesses, devs, pts, sten))))


def _numpy(args):
    return tuple(a.numpy() for a in args)


def _assert_stage(stage, got, want, fused=False):
    """got against want under the module's tolerances; fused: want comes
    from XLA's CPU code, which fuses multiply-adds."""
    assert got.shape == want.shape == (trb.B, 8, 128)
    assert (got == got[:, :, :1]).all()  # every lane of a row equal
    kind = orb.cost_kind(stage)
    if stage == 20:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    elif kind == "trivial" and fused:
        assert ulp_distance(got, want) <= ULPS
    elif kind == "trivial":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_allclose(got[:, :3], want[:, :3], atol=POSE_ATOL)


# ------------------------------------------------------------------ shapes


@needs_jax
def test_entry_point_keeps_the_script_shapes_and_inputs(e7):
    assert (trb.B, trb.P, trb.N, trb.R, trb.K2, trb.ITERS) == (e7.B, e7.P, e7.N, e7.R, e7.K2, e7.ITERS)
    assert (orb.P, orb.ITERS, orb.R, orb.K2) == (e7.P, e7.ITERS, e7.R, e7.K2)
    rs = np.random.RandomState(0)  # the script's run()
    keys = rs.randint(0, 2**31, (e7.B, 2)).astype(np.uint32)
    sten = rs.uniform(0, 1, (e7.B, e7.K2, 8, e7.N)).astype(np.float32)
    pts = rs.uniform(-8, 8, (e7.B, 8, e7.N)).astype(np.float32)
    k, g, d, p, s = _numpy(trb.inputs(torch.device("cpu")))
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(p, pts)
    np.testing.assert_array_equal(s, sten)
    assert (g == 0).all() and (d == np.float32([0.2, 0.2, 0.05])).all()


# ----------------------------------------------- every stage, the script's inputs


@needs_jax
@pytest.mark.parametrize("stage", orb.STAGES)
def test_stage_plain_matches_the_tpu_kernel(e7, stage):
    args = trb.inputs(torch.device("cpu"))
    got = orb.rollout_bisect(stage, *args).numpy()
    want = _jax_stage(e7, stage, *_numpy(args))
    _assert_stage(stage, got, want, fused=True)


# ---------------------------------------------------- inputs whose points bind


@pytest.fixture(scope="module")
def binding():
    return trb.binding_inputs(torch.device("cpu"))


@needs_jax
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_binding_stage_plain_matches_the_tpu_kernel(e7, binding, stage):
    got = orb.rollout_bisect(stage, *binding).numpy()
    want = _jax_stage(e7, stage, *_numpy(binding))
    _assert_stage(stage, got, want, fused=True)


def test_binding_inputs_bind_and_score(binding):
    """On binding_inputs stage 3 scores points (gcost below -1) and stage 2's
    mask sum moves its result off stage 1's; on the script's inputs neither
    holds: no point binds."""
    out = {s: orb.rollout_bisect(s, *binding) for s in (1, 2, 3)}
    assert (out[3][:, 3:] < -1).all()
    assert not torch.equal(out[2], out[1])
    script = {s: orb.rollout_bisect(s, *trb.inputs(torch.device("cpu"))) for s in (1, 2, 3)}
    assert torch.equal(script[2], script[1])
    assert (script[3][:, 3:] == 0).all()


def test_binding_inputs_keep_the_layout():
    keys, guesses, devs, pts, sten = trb.binding_inputs(torch.device("cpu"), b=3, n=64, seed=4)
    assert pts.shape == (3, 8, 64) and sten.shape == (3, 25, 8, 64)
    assert torch.equal(pts[:, 2:4], torch.floor(pts[:, 2:4]))
    assert set(pts[:, 4].unique().tolist()) == {0.0, 1.0}
    assert set(sten[:, :, 5].unique().tolist()) == {0.0, 1.0}
    la, lb, lc = sten[:, :, 2], sten[:, :, 3], sten[:, :, 4]
    assert (la > 0).all() and (la * lc - lb * lb > 0).all()
    assert (pts[:, 5:] == 0).all() and (sten[:, :, 6:] == 0).all()


def test_stage_mapping_and_rejects():
    kinds = [orb.cost_kind(s) for s in orb.STAGES]
    assert kinds[:4] == ["trivial", "trivial", "mask_sum", "quad"]
    assert kinds[4:10] == ["quad"] * 6 and set(kinds[10:]) == {"trivial"}
    args = trb.inputs(torch.device("cpu"))
    with pytest.raises(ValueError, match="stage"):
        orb.rollout_bisect(28, *args)
    with pytest.raises(ValueError, match="bad shapes"):
        orb.rollout_bisect(0, *args[:4], args[4][:, :9])


def test_larger_population_and_iterations_run():
    """Any P and N the kernel takes: P not a multiple of 8, more points and
    iterations; the loop only lowers the incumbent's cost."""
    args = trb.binding_inputs(torch.device("cpu"), b=2, n=100, seed=2)
    first = orb.rollout_bisect(3, *args, population=300, iterations=0)
    last = orb.rollout_bisect(3, *args, population=300, iterations=6)
    assert torch.isfinite(last).all() and (last[:, 3:] <= first[:, 3:]).all()


@pytest.mark.parametrize("stage", [1, 3])
def test_plain_version_runs_in_float64(stage):
    """The plain version in float64 (the witness of what float32 rounding
    moves): the same draws, so on binding inputs, where no decision is
    close, it stays within float32's rounding of the float32 run."""
    args = trb.binding_inputs(torch.device("cpu"), b=2, n=64, seed=3)
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    for iters in (0, 3):
        want = orb.rollout_bisect_reference(stage, *args, population=128, iterations=iters)
        got = orb.rollout_bisect_reference(stage, *a64, population=128, iterations=iters)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got[:, :3].numpy(), want[:, :3].double().numpy(), atol=1e-5)
        np.testing.assert_allclose(got[:, 3:].numpy(), want[:, 3:].double().numpy(), rtol=1e-5)


# ------------------------------------------------------------ entry point


def test_entry_point_runs_every_stage_on_the_cpu():
    res = trb.run(torch.device("cpu"), n=64)
    assert list(res) == list(orb.STAGES)
    assert all(out.shape == (2, 8, 128) and torch.isfinite(out).all() for out, _ in res.values())
    res = trb.run(torch.device("cpu"), stages=(3,), p=64, n=64, binding=True, reps=1)
    assert res[3][1] > 0


def test_entry_point_parses_a_stage_or_all(capsys):
    trb.main(["2", "--device", "cpu"])
    trb.main(["all", "--binding", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "stage 2: OK" in err and "stage 27: OK" in err


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trb.main(["0"])


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("binding_in", [False, True])
def test_kernel_matches_plain_on_gpu(cuda_device, binding_in):
    """Every stage, kernel against plain version on the card: the same
    tolerances as on the CPU (the sin/cos/exp of one device differ less)."""
    make = trb.binding_inputs if binding_in else trb.inputs
    args = make(cuda_device)
    for stage in orb.STAGES:
        before = orb.rollout_bisect.LAUNCHES
        got = orb.rollout_bisect(stage, *args)
        torch.cuda.synchronize()
        assert orb.rollout_bisect.LAUNCHES == before + 1
        want = orb.rollout_bisect_reference(stage, *args)
        _assert_stage(stage, got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
def test_kernel_at_a_wide_population_on_gpu(cuda_device):
    """P = 4096 (8 particles per thread), N = 384: stages 1-3."""
    args = trb.binding_inputs(cuda_device, b=4, n=384, seed=1)
    for stage in (1, 2, 3):
        got = orb.rollout_bisect(stage, *args, population=4096, iterations=5)
        want = orb.rollout_bisect_reference(stage, *args, population=4096, iterations=5)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if stage == 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=COST_RTOL, atol=COST_ATOL)
            np.testing.assert_allclose(got[:, :3], want[:, :3], atol=POSE_ATOL)


@pytest.mark.gpu
def test_first_evaluations_agree_to_sum_order_on_gpu(cuda_device):
    """Stage 3 with no PSO step at K2's widths: its gcost is the least of the
    first 1 + P evaluations, so no decision can move it; it stays within
    one evaluation's sum order of the plain version's (the scores lie in
    [0, 1], so the sum of their magnitudes is |cost|): rtol 1e-5 + 1e-5.
    The kernel takes only float32."""
    args = trb.binding_inputs(cuda_device, b=8, n=384, seed=4)
    got = orb.rollout_bisect(3, *args, population=4096, iterations=0)[:, 3, 0]
    want = orb.rollout_bisect_reference(3, *args, population=4096, iterations=0)[:, 3, 0]
    assert ((got - want).abs() <= 2e-5 * want.abs()).all()
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    with pytest.raises(TypeError, match="float32"):
        orb.rollout_bisect(3, *a64)
