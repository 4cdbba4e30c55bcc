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


@pytest.mark.parametrize("dtype", ["int64", "int32", "uint32"])
def test_io_probe_smem_key_term_in_each_key_dtype(dtype):
    """The plain key term takes k0's u32 word in each dtype the kernel reads
    as given: int64 words (their low 32 bits, also of a negative int64) and
    int32 / uint32 bit patterns, keys >= 2^31 included."""
    words = [0xFFFFFFFF, 0x80000000, 0xDEADBEEF, 255, 0x7FFFFFFF]
    inp = tio.inputs(CPU, b=len(words), n=3, seed=4)
    inp["pts"].zero_()
    k64 = torch.tensor([[w, 7] for w in words], dtype=torch.int64)
    keys = {"int64": k64 - (k64 >= 2**31).to(torch.int64) * 2**32 * torch.tensor([1, 0]),
            "int32": k64.to(torch.int32),  # the bit patterns, wrapped
            "uint32": k64.to(torch.uint32)}[dtype]
    got = probes.io_probe("smem", inp["pts"], keys)
    want = [float(np.int32(w >> 8)) for w in words]
    assert (got == torch.tensor(want)[:, None, None]).all()


def test_io_probe_smem_rejects_keys_of_another_dtype():
    inp = tio.inputs(CPU, b=2, n=4)
    with pytest.raises(TypeError, match="int64, int32 or uint32"):
        probes.io_probe("smem", inp["pts"], inp["keys"].to(torch.float64))
    with pytest.raises(TypeError, match="int64, int32 or uint32"):
        probes.io_probe("smem", inp["pts"], inp["keys"].to(torch.int16))


def _warp_row_sums(rows, vec):
    """csrc/probes.cu's warp_row_sum in float32, step for step, over the
    last axis of rows [..., n]: lane l adds its terms in order (vec: the
    float4s l, l + 32, ..., each one's four components in order; else the
    elements l, l + 32, ...), then a butterfly over the 32 lanes."""
    rows = rows.astype(np.float32)
    n = rows.shape[-1]
    lanes = np.zeros(rows.shape[:-1] + (32,), np.float32)
    if vec:
        quads = rows.reshape(rows.shape[:-1] + (n // 4, 4))
        for i in range(0, n // 4, 32):
            chunk = quads[..., i:i + 32, :]
            w = chunk.shape[-2]
            for c in range(4):
                lanes[..., :w] = lanes[..., :w] + chunk[..., c]
    else:
        for i in range(0, n, 32):
            chunk = rows[..., i:i + 32]
            lanes[..., :chunk.shape[-1]] = lanes[..., :chunk.shape[-1]] + chunk
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    return lanes[..., 0]


def _rows(shape, tile, seed=3):
    """Rows to sum: ones, seeded U(-8, 8), or rows whose second half is
    minus the first plus noise of 1e-6, and an odd last term of 1e-6 (their
    sums nearly 0)."""
    if tile == "ones":
        return np.ones(shape, np.float32)
    rs = np.random.RandomState(seed)
    x = rs.uniform(-8, 8, shape).astype(np.float32)
    if tile == "cancelling":
        half = shape[-1] // 2
        x[..., half:2 * half] = (-x[..., :half] + rs.uniform(-1e-6, 1e-6, x[..., :half].shape)
                                 ).astype(np.float32)
        x[..., 2 * half:] = 1e-6
    return x


@pytest.mark.parametrize("tile", ["ones", "seeded", "cancelling"])
@pytest.mark.parametrize("n", [77, 256, 384])
def test_io_warp_row_sum_order_fits_the_sum_tolerance(n, tile):
    """k_min's and k_smem's warp per row (float4 loads where n % 4 == 0 and
    the row is aligned, scalar loads otherwise) against the plain version,
    within the sum-order tolerance the card holds the kernel to."""
    pts = _rows((3, 8, n), tile)
    if tile == "cancelling":
        assert np.abs(pts.sum(axis=-1)).max() < 1e-3
    src = torch.from_numpy(pts)
    want = probes.io_probe_reference("min", src)[..., 0].numpy()
    atol = SUM_ATOL * probes.io_magnitudes("min", src)[..., 0].numpy()
    for vec in ([True, False] if n % 4 == 0 else [False]):
        got = _warp_row_sums(pts, vec)
        assert (np.abs(got - want) <= SUM_RTOL * np.abs(want) + atol).all()


def _fori_small_twin(x, vec):
    """csrc/probes.cu's k_fori_small in float32, step for step: each warp's
    row sum a and row 0's sum b in warp_row_sum's order, five rounded steps
    of (a + 1, b * 1.01, w * 0.99) from w = 1, then ((x + a) + b) + w."""
    sums = _warp_row_sums(x, vec)
    a, b, w = sums[:, None], np.float32(sums[0]), np.float32(1)
    for _ in range(5):
        a, b, w = a + np.float32(1), b * np.float32(1.01), w * np.float32(0.99)
    return ((x + a) + b) + w


@pytest.mark.parametrize("tile", ["ones", "seeded", "cancelling"])
@pytest.mark.parametrize("p", [512, 1000])
@pytest.mark.parametrize("name", ["bcast_out", "fori_small"])
def test_bcast_out_warp_row_sum_order_fits_the_sum_tolerance(name, p, tile):
    """bcast_out's and fori_small's warps, each summing a whole row (and
    fori_small's also row 0; float4 loads, scalar on a misaligned tile),
    against the plain version within the unchanged tolerance."""
    x = _rows((8, p), tile, seed=p)
    xt = torch.from_numpy(x)
    want = probes.mosaic_probe_reference(name, xt).numpy()
    atol = SUM_ATOL * probes.mosaic_magnitudes(name, xt).numpy()
    for vec in (True, False):
        if name == "bcast_out":
            got = np.broadcast_to(_warp_row_sums(x, vec)[:, None], x.shape)
        else:
            got = _fori_small_twin(x, vec)
        assert got.dtype == np.float32
        assert (np.abs(got - want) <= SUM_RTOL * np.abs(want) + atol).all()


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


# u32 counters >= 2^31 and the corners of the word
THREEFRY_WORDS = [0, 1, 255, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF, 123456789]


@pytest.mark.parametrize("dtype", ["int64", "int32", "uint32", "int16", "uint8"])
def test_mosaic_threefry_counters_in_each_word_dtype(dtype):
    """The plain threefry takes the same u32 counters as int64 words (their
    low 32 bits, also of negative int64s and of int64s above 2^32) and as
    int32 / uint32 bit patterns, and gives the same bits; a tile of another
    integer dtype raises TypeError, as the kernel's wrapper does."""
    w = torch.tensor(THREEFRY_WORDS * 4, dtype=torch.int64).view(8, 4)
    want = probes.mosaic_probe("threefry", w)
    if dtype in ("int16", "uint8"):
        with pytest.raises(TypeError, match="int64, int32 or uint32"):
            probes.mosaic_probe("threefry", w.to(getattr(torch, dtype)))
        return
    tile = {"int64": w - (w >= 2**31).to(torch.int64) * 2**32 + (w % 3 == 0).to(torch.int64) * 2**33,
            "int32": (w - (w >= 2**31).to(torch.int64) * 2**32).to(torch.int32),
            "uint32": w.to(torch.uint32)}[dtype]
    assert torch.equal(probes.mosaic_probe("threefry", tile), want)


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


def _dotgen_twin(x, n_dot):
    """csrc/probes.cu's k_dotgen in float32, step for step: warp r sums row r
    of the head x[:, :n_dot] (lane l its columns l, l + 32, ... in order,
    then a butterfly over the lanes), then every column q takes
    sum_r s_r x[r, q] in order r = 0..7, each product and sum rounded."""
    x = x.astype(np.float32)
    lanes = np.zeros((8, 32), np.float32)
    for c in range(0, n_dot, 32):
        chunk = x[:, c:min(c + 32, n_dot)]
        lanes[:, :chunk.shape[1]] = lanes[:, :chunk.shape[1]] + chunk
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    s = lanes[:, 0]
    acc = s[0] * x[0]
    for r in range(1, 8):
        acc = acc + s[r] * x[r]
    return np.broadcast_to(acc, x.shape)


def _cancelling_tile(seed=7, p=tmo.P, n_dot=probes.N_DOT):
    """A tile whose rows' heads each sum to nearly 0: the second half of
    every head is minus the first, plus noise of 1e-6."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (8, p)).astype(np.float32)
    half = n_dot // 2
    x[:, half:2 * half] = -x[:, :half] + rs.uniform(-1e-6, 1e-6, (8, half)).astype(np.float32)
    return x


@pytest.mark.parametrize("tile", ["ones", "seed5", "seed6", "cancelling"])
def test_dotgen_factored_arithmetic_fits_the_sum_tolerance(tile):
    """The kernel's factored arithmetic (row sums of the head first, then
    sum_r s_r x[r, q]) against the unfactored plain version, within the
    sum-order tolerance the card holds the kernel to."""
    if tile == "cancelling":
        x = _cancelling_tile()
        assert np.abs(x[:, :probes.N_DOT].sum(axis=1)).max() < 1e-4
    else:
        x = tmo.inputs(CPU, seed=None if tile == "ones" else int(tile[-1]))[0].numpy()
    xt = torch.from_numpy(x)
    want = probes.mosaic_probe_reference("dotgen", xt).numpy()
    got = _dotgen_twin(x, probes.N_DOT)
    atol = SUM_ATOL * probes.mosaic_magnitudes("dotgen", xt).numpy()
    assert (np.abs(got - want) <= SUM_RTOL * np.abs(want) + atol).all()


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


def _device_ops(fn):
    """fn's device operations (kernels, copies, fills) under torch.profiler,
    by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


# Profiled windows _one_op_per_call takes before it fails.  Late in a
# process torch.profiler loses records, whole windows of them (ROADMAP T1:
# on an H100 a window of 100 calls came back empty a minute into a pytest
# process), never adds any, so each window holds one call and an empty
# window is taken again.
OPS_TRIES = 10


def _one_op_per_call(call, wrapper, kernel):
    """A call of `call` launches once (its wrapper's LAUNCHES) and makes one
    device operation, `kernel`, in a profiled window of that one call.
    Every window must record nothing but `kernel`, at most once; one that
    recorded nothing is taken again, up to OPS_TRIES windows."""
    for _ in range(OPS_TRIES):
        before = wrapper.LAUNCHES
        ops = _device_ops(call)
        assert wrapper.LAUNCHES == before + 1
        assert sum(ops.values()) <= 1 and all(kernel in k for k in ops), ops
        if ops:
            return
    pytest.fail(f"torch.profiler recorded no device operation in {OPS_TRIES} windows")


def _misaligned(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


IO_SHAPES = [(1, 1), (3, 77), (2, 256), (16, 384), (256, 384), (5, 1001)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", IO_SHAPES)
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
@pytest.mark.parametrize("key_dtype", ["int64", "int32", "uint32"])
@pytest.mark.parametrize("b,n", IO_SHAPES)
def test_io_warp_kernel_layouts_keys_and_nan_on_gpu(cuda_device, b, n, key_dtype):
    """k_min and k_smem: the points aligned and 4 bytes off (float4 and
    scalar loads), a NaN row, keys >= 2^31 in each dtype read as given; one
    launch and one device operation per call, the key term exact."""
    inp = tio.inputs(cuda_device, b=b, n=n, seed=b + n)
    keys = inp["keys"] | (torch.arange(b, device=cuda_device)[:, None] % 2) << 31
    if key_dtype == "int32":  # the u32 words' bit patterns
        keys = (keys - (keys >= 2**31).to(torch.int64) * 2**32).to(torch.int32)
    elif key_dtype == "uint32":
        keys = keys.to(torch.uint32)
    pts = inp["pts"].clone()
    pts[b - 1, 3, n // 2] = float("nan")
    for src in (pts, _misaligned(pts)):
        for name in ("min", "smem"):
            args = (src, keys) if name == "smem" else (src,)
            _one_op_per_call(lambda: probes.io_probe(name, *args), probes.io_probe,
                             "io_kernel_warp")
            got = probes.io_probe(name, *args)
            want = probes.io_probe_reference(name, *args)
            nan = torch.isnan(want)
            assert nan[b - 1, 3].all() and nan.sum() == 128
            assert torch.equal(torch.isnan(got), nan)
            atol = SUM_ATOL * probes.io_magnitudes(name, src)
            ok = (got - want).abs() <= SUM_RTOL * want.abs() + atol
            assert (ok | nan).all()
        zero = torch.zeros_like(src)
        term = probes.io_probe("smem", zero, keys)[:, 0, 0].cpu()
        k0 = keys[:, 0].to(torch.int64).cpu() & 0xFFFFFFFF
        assert torch.equal(term, (k0 >> 8).to(torch.int32).to(torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 3, 512, 1000, 4096])
def test_mosaic_bcast_out_kernel_matches_plain_on_gpu(cuda_device, p):
    """bcast_out's grid of warps at widths below, at and above one warp's
    128 columns, P % 4 != 0 (scalar stores), on ones, a seeded tile and a
    misaligned copy (scalar loads), and with a NaN in one row; one launch
    and one device operation per call."""
    ones, seeded = tmo.inputs(cuda_device, p=p)[0], tmo.inputs(cuda_device, p=p, seed=p)[0]
    nan = seeded.clone()
    nan[5, p // 2] = float("nan")
    for x in (ones, seeded, _misaligned(seeded), nan):
        _one_op_per_call(lambda: probes.mosaic_probe("bcast_out", x), probes.mosaic_probe,
                         "bcast_out")
        got = probes.mosaic_probe("bcast_out", x)
        want = probes.mosaic_probe_reference("bcast_out", x)
        isnan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), isnan)
        assert isnan.sum() == (p if x is nan else 0)
        atol = SUM_ATOL * probes.mosaic_magnitudes("bcast_out", x)
        assert (((got - want).abs() <= SUM_RTOL * want.abs() + atol) | isnan).all()
        rows = ~isnan.any(dim=1)
        assert (got[rows] == got[rows, :1]).all()


TILE_PROBES = ("col3", "bool11", "slice11", "fori_small", "threefry")


def _words(xi, dtype):
    """The u32 counters xi (int64 words below 2^32) in another word dtype:
    int64 with the high word set on every other element (read as its low
    word), int32 bit patterns, or uint32."""
    if dtype == "int64":
        return xi + (torch.arange(xi.numel(), device=xi.device).view(xi.shape) % 2) * 2**32
    if dtype == "int32":
        return (xi - (xi >= 2**31).to(torch.int64) * 2**32).to(torch.int32)
    return xi.to(torch.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 3, 512, 1000, 4096])
@pytest.mark.parametrize("name", TILE_PROBES)
def test_mosaic_tile_probe_kernels_match_plain_on_gpu(cuda_device, name, p):
    """The five single-warp tile probes at widths below, at and above one
    warp's 128 columns, P % 4 != 0 (scalar stores), on ones, a seeded tile, a
    misaligned copy (scalar loads) and a NaN (in row 0 for bool11 and
    fori_small, whose reductions read it; elsewhere for the others);
    threefry on its counters as int64, int32 and uint32 words, also
    misaligned.  Each call is one launch and one device operation, the
    probe's kernel; col3, bool11 and threefry bit-equal to the plain
    version."""
    (ones, ones_i), (seeded, words) = tmo.inputs(cuda_device, p=p), tmo.inputs(cuda_device, p=p, seed=p)
    if name == "threefry":
        tiles = [ones_i, words, _misaligned(words)]
        tiles += [_words(words, d) for d in ("int64", "int32", "uint32")]
        tiles += [_misaligned(_words(words, "int32"))]
    else:
        nan = seeded.clone()
        nan[(0, 0) if name in ("bool11", "fori_small") else (5, p // 2)] = float("nan")
        tiles = [ones, seeded, _misaligned(seeded), nan]
    for x in tiles:
        _one_op_per_call(lambda: probes.mosaic_probe(name, x), probes.mosaic_probe,
                         f"mosaic_kernel_{name}")
        got = probes.mosaic_probe(name, x)
        want = probes.mosaic_probe_reference(name, x)
        isnan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), isnan)
        assert isnan.sum() == (0 if x.dtype != torch.float32 or not torch.isnan(x).any()
                               else isnan.numel() if name in ("bool11", "fori_small") else 1)
        got, want = got[~isnan], want[~isnan]
        if name in EXACT_MOSAIC:
            assert torch.equal(got, want)
        elif name == "slice11":
            torch.testing.assert_close(got, want, rtol=COS_RTOL, atol=COS_ATOL)
        else:
            atol = SUM_ATOL * probes.mosaic_magnitudes(name, x)[~isnan]
            assert ((got - want).abs() <= SUM_RTOL * want.abs() + atol).all()
    if name == "threefry":  # every word dtype gives the int64 words' bits
        want = probes.mosaic_probe(name, words)
        for d in ("int64", "int32", "uint32"):
            assert torch.equal(probes.mosaic_probe(name, _words(words, d)), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_dot,p", [(n, p) for p in (512, 1000, 4096) for n in (1, 7, 256, 1024)
                                     if n <= p])
def test_mosaic_dotgen_kernel_matches_plain_on_gpu(cuda_device, n_dot, p):
    """dotgen's grid over the columns at tiles wider than one block, and
    contraction lengths from 1 to the longest, on seeded tiles and on the
    cancelling one."""
    for x in (tmo.inputs(cuda_device, p=p, seed=n_dot)[0],
              torch.from_numpy(_cancelling_tile(p=p, n_dot=n_dot)).to(cuda_device)):
        got = probes.mosaic_probe("dotgen", x, n_dot)
        want = probes.mosaic_probe_reference("dotgen", x, n_dot)
        atol = SUM_ATOL * probes.mosaic_magnitudes("dotgen", x, n_dot)
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
