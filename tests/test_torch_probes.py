"""The port's single-op probes (ops/probes.py and the entry points
ndtpso_slam_tpu_torch/experiments/io_probe.py and mosaic_probe.py) against
the TPU scripts experiments/io_probe.py and experiments/mosaic_probe.py, on
the CPU.

Both scripts run their kernels when they are imported, so they are loaded
through their syntax trees (test_torch_tpu_scripts.load_script: imports,
constants and functions, no top-level calls; nothing under experiments/
changes).  Their own kernels then run through ``pl.pallas_call(...,
interpret=True)``, io_probe's with the script's GridSpec.  Tolerances, with
their reasons:

* bit for bit: ``col3``, ``bool11`` and ``threefry`` (the same roundings,
  a strict-< decision, the same Threefry words), and ``smem``'s key term
  ``f32(int32(k >> 8))``, which is exact in float32;
* sums in another order (the io probes' row sums, ``fori_small``'s row
  sums, ``dotgen``, ``bcast_out``): rtol 1e-5 and atol 1e-5 times the sum
  of the terms' magnitudes;
* ``slice11``'s cos, XLA-CPU against PyTorch-CPU: the frozen-solve
  tolerance of tests/test_torch_batch.py, rtol 1e-4 / atol 1e-3 (the
  readings: equal on the script's ones and on seeded inputs).

The kernels run only on a GPU: the ``gpu``-marked tests compare each with its
plain version there and skip here.  The GPU machine has no JAX, so run them
there with ``python -m pytest --noconftest -m gpu tests/test_torch_probes.py``.
"""

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch.experiments import io_probe as tio
from ndtpso_slam_tpu_torch.experiments import mosaic_probe as tmo
from ndtpso_slam_tpu_torch.ops import probes

from test_torch_tpu_scripts import load_script

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
except ImportError:  # the GPU machine: no JAX, only the gpu tests run
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (the TPU scripts)")

CPU = torch.device("cpu")
SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
COS_RTOL, COS_ATOL = 1e-4, 1e-3
EXACT_MOSAIC = ("col3", "bool11", "threefry")


@pytest.fixture(scope="module")
def e5():
    return load_script("io_probe", drop=("which",))


@pytest.fixture(scope="module")
def e6():
    return load_script("mosaic_probe")


# ---------------------------------------------------------- E5: io_probe


def _e5_jax(mod, name, inp):
    """The script's kernel for `name` with its GridSpec, interpreted."""
    b, n = inp["pts"].shape[0], inp["pts"].shape[-1]
    out_spec = pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    pts_spec = pl.BlockSpec((1, 8, n), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    kernel, specs, args = {
        "min": (mod.k_min, [pts_spec], (inp["pts"],)),
        "smem": (mod.k_smem, [pl.BlockSpec(memory_space=pltpu.SMEM), pts_spec],
                 (inp["keys"].astype(np.uint32), inp["pts"])),
        "sten3": (mod.k_sten3, [pl.BlockSpec((1, mod.K2 * 8, n), lambda i: (i, 0, 0),
                                             memory_space=pltpu.VMEM)], (inp["sten3"],)),
        "sten4": (mod.k_sten4, [pl.BlockSpec((1, mod.K2, 8, n), lambda i: (i, 0, 0, 0),
                                             memory_space=pltpu.VMEM)], (inp["sten4"],)),
    }[name]
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((b, 8, 128), jnp.float32),
        grid_spec=pl.GridSpec(grid=(b,), in_specs=specs, out_specs=out_spec),
        interpret=True,
    )(*(jnp.asarray(a) for a in args)))


@needs_jax
def test_io_probe_keeps_the_script_shapes_and_inputs(e5):
    assert (tio.B, tio.P, tio.N, tio.K2) == (e5.B, e5.P, e5.N, e5.K2)
    inp = tio.inputs(CPU)
    np.testing.assert_array_equal(inp["keys"].numpy(), np.asarray(e5.keys))
    np.testing.assert_array_equal(inp["pts"].numpy(), np.asarray(e5.pts))
    np.testing.assert_array_equal(inp["sten4"].numpy(), np.asarray(e5.sten4))
    np.testing.assert_array_equal(inp["sten3"].numpy(), np.asarray(e5.sten3))
    assert list(tio.PROBES) == ["min", "smem", "sten3", "sten4"]


@needs_jax
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", probes.IO_PROBES)
def test_io_probe_plain_matches_the_tpu_kernel(e5, name, seed):
    inp = tio.inputs(CPU, seed=seed)
    args = tio.probe_args(name, inp)
    got = probes.io_probe(name, *args)
    want = _e5_jax(e5, name, {k: v.numpy() for k, v in inp.items()})
    assert got.shape == want.shape == (tio.B, 8, 128)
    assert (got == got[:, :, :1]).all()
    atol = SUM_ATOL * probes.io_magnitudes(name, args[0]).numpy()
    assert (np.abs(got.numpy() - want) <= SUM_RTOL * np.abs(want) + atol).all()


def test_io_probe_smem_key_term_is_exact():
    """smem minus min is f32(int32(k0 >> 8)) exactly, for the largest keys too."""
    inp = tio.inputs(CPU, b=3, n=1)
    inp["pts"].zero_()
    keys = torch.tensor([[0xFFFFFFFF, 1], [0x80000000, 2], [255, 3]], dtype=torch.int64)
    got = probes.io_probe("smem", inp["pts"], keys)
    assert got[:, 0, 0].tolist() == [16777215.0, 8388608.0, 0.0]


def test_io_probe_rejects_bad_inputs():
    inp = tio.inputs(CPU)
    with pytest.raises(ValueError, match="unknown io probe"):
        probes.io_probe("max", inp["pts"])
    with pytest.raises(ValueError, match="expected"):
        probes.io_probe("sten4", inp["sten3"])
    with pytest.raises(ValueError, match="keys"):
        probes.io_probe("smem", inp["pts"])


def test_io_probe_entry_point_runs_on_the_cpu(capsys):
    res = tio.run(CPU, b=3, n=40, reps=1)
    assert list(res) == list(tio.PROBES)
    for name, (out, ms) in res.items():
        assert out.shape == (3, 8, 128) and torch.isfinite(out).all() and ms > 0
    tio.main(["sten4", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "min 3D pts: OK" in err and err.count("sten 4D: OK") == 2


def test_io_probe_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tio.main([])


# ------------------------------------------------------ E6: mosaic_probe


def _e6_jax(mod, name, x, xi):
    kernel = getattr(mod, f"k_{name}")
    arg = xi.astype(np.uint32) if name == "threefry" else x
    return np.asarray(pl.pallas_call(kernel, out_shape=mod.o8p, interpret=True)(jnp.asarray(arg)))


@needs_jax
def test_mosaic_probe_keeps_the_script_shapes_and_inputs(e6):
    assert (tmo.P, tmo.N, probes.N_DOT) == (e6.P, e6.N, e6.N)
    x, xi = tmo.inputs(CPU)
    np.testing.assert_array_equal(x.numpy(), np.asarray(e6.x))
    np.testing.assert_array_equal(xi.numpy(), np.asarray(e6.xi))
    assert list(tmo.PROBES) == list(probes.MOSAIC_PROBES)


@needs_jax
@pytest.mark.parametrize("seed", [None, 5])
@pytest.mark.parametrize("name", probes.MOSAIC_PROBES)
def test_mosaic_probe_plain_matches_the_tpu_kernel(e6, name, seed):
    x, xi = tmo.inputs(CPU, seed=seed)
    got = probes.mosaic_probe(name, xi if name == "threefry" else x).numpy()
    want = _e6_jax(e6, name, x.numpy(), xi.numpy())
    assert got.shape == want.shape == (8, tmo.P) and got.dtype == want.dtype
    if name in EXACT_MOSAIC:
        np.testing.assert_array_equal(got, want)
    elif name == "slice11":
        np.testing.assert_allclose(got, want, rtol=COS_RTOL, atol=COS_ATOL)
    else:
        atol = SUM_ATOL * probes.mosaic_magnitudes(name, x).numpy()
        assert (np.abs(got - want) <= SUM_RTOL * np.abs(want) + atol).all()


def test_mosaic_threefry_is_the_ports_threefry_of_counter_x_0():
    from ndtpso_slam_tpu_torch.ops import rng

    _, xi = tmo.inputs(CPU, seed=3)
    x0, _ = rng.threefry2x32(probes.THREEFRY_KEY, xi, torch.zeros_like(xi))
    want = (x0 >> 8).to(torch.int32).to(torch.float32)
    assert torch.equal(probes.mosaic_probe("threefry", xi), want)


def test_mosaic_bool11_takes_row_zeros_minimum_and_keeps_nan():
    x = torch.full((8, 16), 3.0)
    x[0, 5], x[1, 0] = 0.25, -9.0  # row 1's minimum is not the one taken
    assert torch.equal(probes.mosaic_probe("bool11", x), x + 0.25)
    x[0, 5] = 0.75
    assert torch.equal(probes.mosaic_probe("bool11", x), x + 1.75)
    x[0, 2] = float("nan")
    assert torch.isnan(probes.mosaic_probe("bool11", x)).all()


def test_mosaic_probe_rejects_bad_inputs():
    x, xi = tmo.inputs(CPU)
    with pytest.raises(ValueError, match="unknown mosaic probe"):
        probes.mosaic_probe("dot", x)
    with pytest.raises(TypeError, match="u32"):
        probes.mosaic_probe("threefry", x)
    with pytest.raises(ValueError, match="n_dot"):
        probes.mosaic_probe("dotgen", x, n_dot=x.shape[1] + 1)
    with pytest.raises(ValueError, match=r"\[8, P\]"):
        probes.mosaic_probe("col3", x[:4])


def test_mosaic_probe_entry_point_runs_on_the_cpu(capsys):
    res = tmo.run(CPU, seed=1, reps=1)
    assert list(res) == list(tmo.PROBES)
    for name, (out, ms) in res.items():
        assert out.shape == (8, tmo.P) and torch.isfinite(out).all() and ms > 0
    tmo.main(["--device", "cpu"])
    err = capsys.readouterr().err
    assert all(err.count(f"{label}: OK") == 2 for label in tmo.PROBES.values())


def test_mosaic_probe_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmo.main([])


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(2, 256), (16, 384), (3, 77)])
@pytest.mark.parametrize("name", probes.IO_PROBES)
def test_io_probe_kernel_matches_plain_on_gpu(cuda_device, name, b, n):
    inp = tio.inputs(cuda_device, b=b, n=n, seed=2)
    before = probes.io_probe.LAUNCHES
    got = probes.io_probe(name, *tio.probe_args(name, inp))
    torch.cuda.synchronize()
    assert probes.io_probe.LAUNCHES == before + 1
    args = tio.probe_args(name, inp)
    want = probes.io_probe_reference(name, *args)
    atol = SUM_ATOL * probes.io_magnitudes(name, args[0])
    assert ((got - want).abs() <= SUM_RTOL * want.abs() + atol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [None, 5])
@pytest.mark.parametrize("name", probes.MOSAIC_PROBES)
def test_mosaic_probe_kernel_matches_plain_on_gpu(cuda_device, name, seed):
    x, xi = tmo.inputs(cuda_device, seed=seed)
    arg = xi if name == "threefry" else x
    before = probes.mosaic_probe.LAUNCHES
    got = probes.mosaic_probe(name, arg)
    torch.cuda.synchronize()
    assert probes.mosaic_probe.LAUNCHES == before + 1
    want = probes.mosaic_probe_reference(name, arg)
    if name in EXACT_MOSAIC:
        assert torch.equal(got, want)
    elif name == "slice11":
        torch.testing.assert_close(got, want, rtol=COS_RTOL, atol=COS_ATOL)
    else:
        atol = SUM_ATOL * probes.mosaic_magnitudes(name, x)
        assert ((got - want).abs() <= SUM_RTOL * want.abs() + atol).all()
