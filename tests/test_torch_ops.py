"""PyTorch port against the JAX package: config, Threefry, geometry, Gaussian
math and scan loading, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages.
Threefry words and integer cell indices must match bit for bit.  Where a
comparison allows a tolerance, the reason is given beside it: PyTorch's and
XLA's CPU sin/cos/exp differ in the last ulp.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpso_slam_tpu import config as jcfg
from ndtpso_slam_tpu.models import scan as jscan
from ndtpso_slam_tpu.ops import gaussian as jgauss
from ndtpso_slam_tpu.ops import geometry as jgeo
from ndtpso_slam_tpu.ops import rng as jrng
from ndtpso_slam_tpu.utils import native

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.ops import gaussian as tgauss
from ndtpso_slam_tpu_torch.ops import geometry as tgeo
from ndtpso_slam_tpu_torch.ops import rng as trng

KEYS = [(0xDEADBEEF, 0x12345), (0, 0), (0xFFFFFFFF, 0x9E3779B9)]


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("name", [
    "PSOConfig", "MapConfig", "ScanConfig", "OccupancyGridConfig",
    "RecoveryConfig", "SlamConfig",
])
def test_config_fields_and_defaults_match(name):
    j = _fields(getattr(jcfg, name)())
    t = _fields(getattr(tcfg, name)())
    if name == "SlamConfig":
        assert j.pop("dtype") == jnp.float32
        assert t.pop("dtype") == torch.float32
    assert t == j


def test_scan_launch_config_and_map_geometry_match():
    j, t = jcfg.scan_launch_config(), tcfg.scan_launch_config()
    assert _fields(t.map) == _fields(j.map) and _fields(t.pso) == _fields(j.pso)
    assert _fields(t.og) == _fields(j.og)
    assert (t.map.cells_per_side, t.map.num_cells) == (600, 360_000)
    assert t.map.patch_cells_for_range(30.0) == j.map.patch_cells_for_range(30.0)


@pytest.mark.parametrize("key", KEYS)
def test_threefry_bitwise_vs_jax_and_golden(key):
    rs = np.random.RandomState(key[0] & 0xFFFF)
    c0 = np.concatenate([np.arange(512), rs.randint(0, 2**32, 512, dtype=np.uint64)]).astype(np.uint32)
    c1 = rs.randint(0, 2**32, c0.size, dtype=np.uint64).astype(np.uint32)
    t0, t1 = trng.threefry2x32(key, torch.from_numpy(c0.astype(np.int64)), c1)
    j0, j1 = jrng.threefry2x32((np.uint32(key[0]), np.uint32(key[1])), c0, c1)
    g0, g1 = native.golden_threefry(key, c0, c1)
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), np.asarray(j1))
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), g0)
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), g1)


@pytest.mark.parametrize("key", KEYS)
def test_uniform_pairs_and_derived_keys_bitwise(key):
    jkey = (np.uint32(key[0]), np.uint32(key[1]))
    ctr = np.arange(4096, dtype=np.uint32).reshape(8, 512)
    tu0, tu1 = trng.uniform_pairs(key, torch.from_numpy(ctr.astype(np.int64)))
    ju0, ju1 = jrng.uniform_pairs(jkey, ctr)
    np.testing.assert_array_equal(tu0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(tu1.numpy(), np.asarray(ju1))
    for step in (0, 1, 17, 2**31 + 5):
        j0, j1 = jrng.threefry2x32(jkey, np.uint32(step), np.uint32(0))
        assert trng.derive_key(key, step) == (int(j0), int(j1))


def test_pso_counter_protocol_matches():
    for p in (1, 50, 200):
        jg, jp = jrng.pso_init_pairs(p)
        tg, tp = trng.pso_init_pairs(p)
        np.testing.assert_array_equal(tg.numpy(), jg)
        np.testing.assert_array_equal(tp.numpy(), jp)
        assert trng.pso_iter_pair_base(p) == jrng.pso_iter_pair_base(p)
        for i in (0, 7, 29):
            np.testing.assert_array_equal(
                trng.pso_iter_pairs(i, p).numpy(), np.asarray(jrng.pso_iter_pairs(i, p))
            )


def _border_points(size_m, cell):
    """Points on and next to the frame borders and cell edges, plus random
    ones inside and outside the frame."""
    half = np.float32(size_m / 2)
    edges = np.float32(-half + cell * np.arange(0, int(round(size_m / cell)) + 1))
    near = np.concatenate([
        edges,
        np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
        [-half, half, np.float32(0.0), np.float32(-0.0)],
    ]).astype(np.float32)
    rs = np.random.RandomState(7)
    xs = rs.choice(near, 600)
    ys = rs.choice(near, 600)
    rand = rs.uniform(-1.2 * half, 1.2 * half, (400, 2)).astype(np.float32)
    return np.concatenate([np.stack([xs, ys], -1), rand]).astype(np.float32)


@pytest.mark.parametrize("size_m,cell", [(16.0, 1.0), (36.0, 0.5), (300.0, 0.5), (10.0, 0.3)])
def test_cell_binning_bitwise_at_borders(size_m, cell):
    pts = _border_points(size_m, cell)
    w = int(np.ceil(size_m / cell))
    jx, jy, jinb = jgeo.cell_coords(jnp.asarray(pts), size_m=size_m, cell_side_m=cell)
    tx, ty, tinb = tgeo.cell_coords(torch.from_numpy(pts), size_m=size_m, cell_side_m=cell)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tinb.numpy(), np.asarray(jinb))
    ji, jb = jgeo.cell_index(jnp.asarray(pts), size_m=size_m, cell_side_m=cell, cells_per_side=w)
    ti, tb = tgeo.cell_index(torch.from_numpy(pts), size_m=size_m, cell_side_m=cell, cells_per_side=w)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # XLA's CPU code flushes subnormals to zero and PyTorch's does not, so
    # origin_at (which divides the raw coordinate) is compared on normal
    # floats; the binning above adds half the frame first, which leaves no
    # subnormal.
    normal = ((np.abs(pts) >= np.finfo(np.float32).tiny) | (pts == 0)).all(-1)
    np.testing.assert_array_equal(
        tgeo.origin_at(torch.from_numpy(pts[normal]), cell).numpy(),
        np.asarray(jgeo.origin_at(jnp.asarray(pts[normal]), cell)),
    )
    # Strict borders: a point exactly on the frame edge is out of bounds.
    h = np.float32(size_m / 2)
    _, edge_inb = tgeo.cell_index(
        torch.tensor([[h, 0.0], [-h, 0.0], [0.0, h], [0.0, -h]]),
        size_m=size_m, cell_side_m=cell, cells_per_side=w,
    )
    assert not edge_inb.any()


def test_transform_and_se2_match():
    rs = np.random.RandomState(3)
    pts = rs.uniform(-30, 30, (256, 2)).astype(np.float32)
    poses = np.concatenate([
        rs.uniform(-5, 5, (5, 2)), rs.uniform(-np.pi, np.pi, (5, 1))
    ], -1).astype(np.float32)
    j = np.asarray(jgeo.transform_points(jnp.asarray(pts), jnp.asarray(poses)))
    t = tgeo.transform_points(torch.from_numpy(pts), torch.from_numpy(poses)).numpy()
    # sin/cos differ by an ulp between the two CPU libraries: ~4e-6 at 30 m.
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=2e-5)
    a, b = poses[:3], poses[2:]
    for fj, ft, args in (
        (jgeo.se2_compose, tgeo.se2_compose, (a, b)),
        (jgeo.se2_inverse, tgeo.se2_inverse, (a,)),
        (jgeo.wrap_angle, tgeo.wrap_angle, (4.0 * poses[:, 2],)),
    ):
        jv = np.asarray(fj(*[jnp.asarray(x) for x in args]))
        tv = ft(*[torch.from_numpy(np.ascontiguousarray(x)) for x in args]).numpy()
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=2e-6)


COVS = {
    "well_conditioned": [1.0, 0.2, 0.5],
    "thin_regularized": [1e-6, 0.0, 1.0],
    "rank_one": [1.0, 1.0, 1.0],
    "indefinite": [0.3, 0.1, -0.2],
    "indefinite_offdiag": [1.0, 2.0, 1.0],
    "degenerate_zero": [0.0, 0.0, 0.0],
}


@pytest.mark.parametrize("name", sorted(COVS))
def test_regularized_inverse_matches(name):
    rs = np.random.RandomState(5)
    cov = np.concatenate([
        np.float32([COVS[name]]),
        rs.normal(0, 0.1, (64, 3)).astype(np.float32),
    ])
    j = np.asarray(jgauss.regularized_inverse(jnp.asarray(cov)))
    t = tgauss.regularized_inverse(torch.from_numpy(cov)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, equal_nan=True)
    if name == "degenerate_zero":
        assert not np.isfinite(t[0]).any()
    if name.startswith("indefinite"):
        # The adjugate is kept: the inverse stays indefinite.
        a, b, c = t[0]
        assert a * c - b * b < 0


def test_ndt_score_matches():
    rs = np.random.RandomState(6)
    d = rs.normal(0, 0.3, (500, 2)).astype(np.float32)
    icov = np.abs(rs.normal(10, 3, (500, 3))).astype(np.float32)
    icov[:, 1] *= 0.1
    built = rs.rand(500) > 0.3
    j = np.asarray(jgauss.ndt_score(jnp.asarray(d), jnp.asarray(icov), jnp.asarray(built)))
    t = tgauss.ndt_score(torch.from_numpy(d), torch.from_numpy(icov), torch.from_numpy(built)).numpy()
    # exp differs by an ulp between the two CPU libraries.
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    assert (t[~built] == 0).all()


@pytest.mark.parametrize("with_mount,with_map,n_beams", [
    (False, False, 360), (True, True, 300), (False, True, 512),
])
def test_load_laser_matches(with_mount, with_map, n_beams):
    rs = np.random.RandomState(n_beams)
    ranges = rs.uniform(0, 35, n_beams).astype(np.float32)
    ranges[::7] = 0.0
    ranges[1::11] = 0.05  # below the ignore epsilon
    mount = np.float32([0.65, -0.1, 0.3]) if with_mount else None
    jsc, jm = jcfg.ScanConfig(max_beams=512), jcfg.MapConfig(size_m=40.0, cell_side_m=0.5)
    tsc, tm = tcfg.ScanConfig(max_beams=512), tcfg.MapConfig(size_m=40.0, cell_side_m=0.5)
    j = jscan.load_laser(ranges, -np.pi, 2 * np.pi / n_beams, 30.0, jsc,
                         jm if with_map else None, mount=mount)
    t = tscan.load_laser(ranges, -np.pi, 2 * np.pi / n_beams, 30.0, tsc,
                         tm if with_map else None, mount=mount, device="cpu")
    assert t.points.shape == (512, 2) and t.valid.shape == (512,)
    # Same sin/cos ulp caveat as above, at ranges up to 35 m.
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), rtol=1e-6, atol=2e-5)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert not t.valid[n_beams:].any()


def test_frontal_keep_mask_matches_reference_loop():
    theta = torch.linspace(-np.pi, np.pi, 721)[:-1]
    valid = torch.from_numpy(np.random.RandomState(9).rand(720) > 0.2)
    got = tscan._frontal_keep_mask(theta, valid).numpy()
    want = np.asarray(jscan._frontal_keep_mask(jnp.asarray(theta.numpy()), jnp.asarray(valid.numpy())))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def test_load_laser_rejects_too_many_beams():
    with pytest.raises(ValueError, match="max_beams"):
        tscan.load_laser(np.ones(600, np.float32), -np.pi, 0.01, 30.0,
                         tcfg.ScanConfig(max_beams=512), device="cpu")


@pytest.mark.parametrize("dtype", ["int64", "uint32"])
def test_u32_words_masks_other_integer_words(dtype):
    from ndtpso_slam_tpu_torch.ops import _build

    words = torch.tensor([[0xFFFFFFFF, 0x80000000], [0x7FFFFFFF, 5]], dtype=torch.int64)
    got = _build.u32_words(words.to(getattr(torch, dtype)), "cpu")
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.tolist() == [[-1, -2**31], [2**31 - 1, 5]]
    assert torch.equal(got.to(torch.int64) & 0xFFFFFFFF, words)


def test_u32_words_returns_int32_words_on_the_device_as_they_are():
    from ndtpso_slam_tpu_torch.ops import _build

    words = torch.tensor([[-1, 7], [-2**31, 2**31 - 1]], dtype=torch.int32)
    assert _build.u32_words(words, "cpu") is words
    assert _build.u32_words(words, torch.device("cpu")) is words
    strided = words.t()  # not contiguous: copied, the same words
    got = _build.u32_words(strided, "cpu")
    assert got is not strided and got.is_contiguous() and torch.equal(got, strided)


def test_align_rollout_key_words_are_the_int64_words_low_bits(monkeypatch):
    """_align_rollout hands the kernel int32 bit patterns made on the host
    (u32_words' host route): the low 32 bits of the int64 words it made
    before, so u32_words needs no device operation and the draws stay
    bit-equal."""
    from types import SimpleNamespace

    from ndtpso_slam_tpu_torch.models import slam as tslam
    from ndtpso_slam_tpu_torch.ops import _build

    seen = []

    def solve(mode, keys, guesses, *args, **kwargs):
        seen.append(keys)
        return guesses.clone(), torch.zeros(1)

    monkeypatch.setattr(tslam, "solve_rollout_mode", solve)
    cfg = SimpleNamespace(cost_mode="rollout_local", map=None, pso=None, solver_early_exit=0)
    scan = SimpleNamespace(points=torch.zeros(4, 2), valid=torch.ones(4, dtype=torch.bool))
    guess = torch.zeros(3)
    keys = KEYS + [trng.derive_key(k, 7) for k in KEYS] + [(2**31, 2**31 - 1)]
    for key in keys:
        tslam._align_rollout(key, guess, guess, None, scan, cfg)
        old = torch.tensor([[key[0], key[1]]], dtype=torch.int64)
        got = seen[-1]
        assert got.dtype == torch.int32 and _build.u32_words(got, "cpu") is got
        assert torch.equal(got, _build.u32_words(old, "cpu"))
        assert torch.equal(got.to(torch.int64) & 0xFFFFFFFF, old & 0xFFFFFFFF)
        host = _build.u32_words(key, "cpu")  # the host route, one pair
        assert host.dtype == torch.int32 and host.shape == (1, 2) and torch.equal(host, got)
    # The host route of B pairs: keys >= 2^31 keep their low words' bits.
    host = _build.u32_words(keys, "cpu")
    assert host.dtype == torch.int32 and host.shape == (len(keys), 2)
    want = torch.tensor(keys, dtype=torch.int64) & 0xFFFFFFFF
    assert torch.equal(host.to(torch.int64) & 0xFFFFFFFF, want)
    assert host[-1].tolist() == [-2**31, 2**31 - 1]
