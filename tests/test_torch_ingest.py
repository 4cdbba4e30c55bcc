"""The step's map update in one launch (ops/ndt_ingest.py, csrc/ndt_ingest.cu)
and the route to it (models/ndt_map.py:ingest_scan).

On the CPU: ``ingest_scan`` takes the PyTorch ops on the CPU, with a dense
or a sparse ring, and never launches; the wrapper's checks raise on a wrong
device, dtype, shape or layout before the library is loaded.

The ``gpu`` tests hold the kernel to ``ingest_scan_reference`` on the same
inputs on the card, in float32 and float64.  They run the PyTorch path under
``torch.use_deterministic_algorithms``, where CUDA's ``index_add_`` adds a
cell's beams in index order, as the kernel does; so the ids, the integer and
bool fields and the float fields are compared bit for bit, in every real row
(the PyTorch path also writes the spare row C, which nothing reads).  Over
50 node steps at scan.launch scale, the two paths' poses are held to the
card's trajectory tolerance.  The GPU machine has no JAX, and this file
imports none: ``python -m pytest --noconftest -m gpu tests/test_torch_ingest.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndtpso_slam_tpu_torch import config as tcfg
from ndtpso_slam_tpu_torch.io import synthetic as tsynth
from ndtpso_slam_tpu_torch.models import ndt_map as tmap
from ndtpso_slam_tpu_torch.models import scan as tscan
from ndtpso_slam_tpu_torch.ops import _build
from ndtpso_slam_tpu_torch.ops import ndt_ingest as tni
from ndtpso_slam_tpu_torch.ops.geometry import transform_points

# The card's trajectory tolerance (tests/test_torch_slam.py).
TRAJ_ATOL = 5e-4
SMALL = tcfg.MapConfig(size_m=16.0, cell_side_m=1.0, window_slots=100, slot_capacity=5)
N = 384


def _clone(state):
    return tmap.NdtMapState(**{f.name: getattr(state, f.name).clone()
                               for f in dataclasses.fields(state)})


def _bits(t):
    """Floats as their bit patterns, so NaNs compare and -0 differs from 0."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _assert_maps_equal(a, b, rows=None, floats_skip=None):
    """Every field bit for bit: the first ``rows`` rows, and of the float
    fields those rows ``floats_skip`` [rows] leaves out."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if rows is not None and x.dim():
            x, y = x[:rows], y[:rows]
        if floats_skip is not None and x.is_floating_point():
            x, y = x[~floats_skip], y[~floats_skip]
        assert torch.equal(_bits(x), _bits(y)), f.name


def _to_cpu(state):
    return tmap.NdtMapState(**{f.name: getattr(state, f.name).cpu()
                               for f in dataclasses.fields(state)})


def _clustered(rs, n, centres, spread):
    return centres[rs.randint(0, len(centres), n)] + rs.normal(0, spread, (n, 2))


def _scans(name, dtype):
    """(map config, [(pose [3], points [N, 2], valid [N])] on the CPU, a
    preparation of the fresh map) of each case."""
    rs = np.random.RandomState(7)
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt)
    scans, prep = [], None
    if name == "patrol":
        cfg = tcfg.MapConfig(size_m=300.0, cell_side_m=0.5)  # scan.launch
        lg = tsynth.make_log(seed=2, n_scans=6, n_beams=360, world_size=50.0)
        for i in range(6):
            sc = tscan.load_laser(lg.ranges[i], lg.angle_min, lg.angle_increment, lg.range_max,
                                  tcfg.ScanConfig(max_beams=N), cfg, dtype=dtype, device="cpu")
            scans.append((t(lg.poses[i]), sc.points, sc.valid))
    elif name == "one_cell":
        cfg = SMALL
        pose = np.array([2.0, 1.0, 0.01])
        for _ in range(3):
            world = np.array([3.3, 3.4]) + rs.normal(0, 0.05, (N, 2))
            c, s = np.cos(-pose[2]), np.sin(-pose[2])
            d = world - pose[:2]
            local = np.stack([d[:, 0] * c - d[:, 1] * s, d[:, 0] * s + d[:, 1] * c], -1)
            scans.append((t(pose), t(local), torch.ones(N, dtype=torch.bool)))
    elif name == "out_of_frame":
        cfg = SMALL
        for _ in range(3):
            pts = rs.uniform(-12.0, 12.0, (N, 2))
            pts[:4] = [[8.0, 0.5], [-8.0, 1.0], [7.999, -7.999], [0.5, 8.0]]
            valid = rs.rand(N) > 0.3
            pts[5:20:3] = np.nan
            pts[6:20:3] = np.inf
            valid[5:20] = False
            scans.append((t([0.0, 0.0, 0.0]), t(pts), t(valid, torch.bool)))
    elif name == "wrap":
        cfg = SMALL

        def prep(state):  # every cell's open slot near the ring's end
            state.slot_idx.fill_(97)

        for k in range(8):
            centres = np.array([[3.3, 3.3], [-4.6, 2.2], [1.5, -5.7]])
            pts = _clustered(rs, 60, centres, 0.3)
            scans.append((t([0.05 * k, -0.03 * k, 0.02 * k]), t(pts),
                          t(rs.rand(60) > 0.1, torch.bool)))
    elif name == "few_points":
        cfg = tcfg.MapConfig(size_m=60.0, cell_side_m=1.0, window_slots=4, slot_capacity=5)
        centres = np.stack(np.meshgrid(np.arange(-25.5, 25.0, 2.0), np.arange(-25.5, 0, 2.0)),
                           -1).reshape(-1, 2)
        # One, two or three beams a cell: cells of at most two stay unbuilt.
        reps = rs.randint(1, 4, len(centres))
        pts = np.repeat(centres, reps, 0)[:N] + rs.uniform(-0.4, 0.4, (min(N, reps.sum()), 2))
        pts = np.concatenate([pts, np.zeros((N - len(pts), 2))])
        valid = np.arange(N) < min(N, reps.sum())
        scans.append((t([0.0, 0.0, 0.0]), t(pts), t(valid, torch.bool)))
    elif name == "cell_side_0.3":
        cfg = tcfg.MapConfig(size_m=30.0, cell_side_m=0.3, window_slots=8, slot_capacity=5)
        centres = rs.uniform(-10.0, 10.0, (12, 2))
        for k in range(4):
            scans.append((t([0.1 * k, 0.2, -0.05 * k]), t(_clustered(rs, N, centres, 0.4)),
                          t(rs.rand(N) > 0.05, torch.bool)))
    return cfg, scans, prep


CASES = ("patrol", "one_cell", "out_of_frame", "wrap", "few_points", "cell_side_0.3")


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("ring_rows", [0, 64])
def test_ingest_scan_takes_pytorch_ops_on_cpu(monkeypatch, ring_rows):
    """On the CPU, with a dense or a sparse ring, ingest_scan takes the
    PyTorch ops (bit for bit, every row): no library is loaded and the launch
    counter does not move."""
    monkeypatch.setattr(_build, "load", lambda lib: pytest.fail(f"loaded {lib.name}"))
    cfg = dataclasses.replace(SMALL, window_slots=4, ring_rows=ring_rows)
    _, scans, _ = _scans("wrap", torch.float32)
    a = tmap.init_map(cfg, device="cpu")
    b = _clone(a)
    prev_a = prev_b = torch.full((60,), cfg.num_cells, dtype=torch.int32)
    before = tni.ndt_ingest.LAUNCHES
    for pose, pts, valid in scans:
        prev_a = tmap.ingest_scan(a, cfg, pose, pts, valid, prev_a)
        prev_b = tmap.ingest_scan_reference(b, cfg, pose, pts, valid, prev_b)
        assert torch.equal(prev_a, prev_b)
    _assert_maps_equal(a, b)
    assert tni.ndt_ingest.LAUNCHES == before
    assert int(a.rot_count.max()) >= 1 and bool(a.built.any())


def _good_args(n=8):
    cfg = SMALL
    state = tmap.init_map(cfg, device="cpu")
    return dict(state=state, cfg=cfg, pose=torch.zeros(3), points=torch.zeros(n, 2),
                valid=torch.ones(n, dtype=torch.bool),
                prev_ids=torch.full((n,), cfg.num_cells, dtype=torch.int32))


def _with_field(args, name, value):
    args["state"] = dataclasses.replace(args["state"], **{name: value})


def _bad(case):
    args = _good_args()
    rows = SMALL.num_cells + 1
    if case == "cpu":
        pass
    elif case == "sparse_ring":
        args["cfg"] = dataclasses.replace(SMALL, ring_rows=64)
    elif case == "map_float16":
        args["state"] = tmap.init_map(SMALL, dtype=torch.float16, device="cpu")
    elif case == "field_dtype":
        _with_field(args, "g_count", torch.zeros(rows, dtype=torch.int64))
    elif case == "field_shape":
        _with_field(args, "cur_sum", torch.zeros(rows - 1, 2))
    elif case == "slot_shape":
        _with_field(args, "slot_cov", torch.zeros(rows, 4, 3))
    elif case == "field_noncontiguous":
        _with_field(args, "cur_m2", torch.zeros(3, rows).t())
    elif case == "pose_shape":
        args["pose"] = torch.zeros(4)
    elif case == "points_dtype":
        args["points"] = args["points"].double()
    elif case == "points_shape":
        args["points"] = torch.zeros(8, 3)
    elif case == "points_noncontiguous":
        args["points"] = torch.zeros(2, 8).t()
    elif case == "valid_dtype":
        args["valid"] = args["valid"].to(torch.uint8)
    elif case == "prev_ids_dtype":
        args["prev_ids"] = args["prev_ids"].long()
    elif case == "prev_ids_shape":
        args["prev_ids"] = args["prev_ids"][:7]
    elif case == "too_many_beams":
        args.update({k: v for k, v in _good_args(tni.MAX_BEAMS + 1).items()
                     if k in ("points", "valid", "prev_ids")})
    return args


BAD = {"cpu": "CUDA", "sparse_ring": "dense ring", "map_float16": "float32 or float64",
       "field_dtype": "g_count", "field_shape": "cur_sum", "slot_shape": "slot_cov",
       "field_noncontiguous": "cur_m2 must be contiguous", "pose_shape": "pose",
       "points_dtype": "points", "points_shape": r"points must be \[N, 2\]",
       "points_noncontiguous": "points must be contiguous", "valid_dtype": "valid",
       "prev_ids_dtype": "prev_ids", "prev_ids_shape": "prev_ids",
       "too_many_beams": f"{tni.MAX_BEAMS + 1} beams"}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_checks_raise_before_loading(monkeypatch, case):
    """Every argument the kernel does not take raises ValueError from the
    wrapper's checks (the device last), before the library is loaded."""
    monkeypatch.setattr(_build, "load", lambda lib: pytest.fail(f"loaded {lib.name}"))
    before = tni.ndt_ingest.LAUNCHES
    with pytest.raises(ValueError, match=BAD[case]):
        tni.ndt_ingest(**_bad(case))
    assert tni.ndt_ingest.LAUNCHES == before


@pytest.mark.parametrize("n", [1, 31, 384, 640, tni.MAX_BEAMS])
def test_launch_shape(n):
    """The table has 4n to 8n slots, the block whole warps covering the 2n
    ids up to 1,024 threads, and the shared memory fits an H100's block at
    float64 up to MAX_BEAMS."""
    slots = 1 << (32 - tni.table_shift(n))
    assert 4 * n <= slots < 8 * n
    th = tni.threads(n)
    assert th % 32 == 0 and min(2 * n, tni.MAX_THREADS) <= th <= tni.MAX_THREADS
    assert tni.smem_bytes(n, torch.float64) <= 232_448
    assert tni.smem_bytes(n, torch.float32) < tni.smem_bytes(n, torch.float64)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _to(scan, device):
    return tuple(x.to(device) for x in scan)


def _check_case(case, a, ids, c, n_scans):
    real = slice(0, c)
    assert bool(a.created[real].any())
    if case == "one_cell":
        assert int((ids < c).sum()) == N and int(a.rot_count.max()) == n_scans
    if case == "out_of_frame":
        assert 0 < int((ids < c).sum()) < N
    if case == "wrap":  # the ring went 97 -> 98 -> 99 -> 0 and on
        assert bool(((a.rot_count[real] >= 3) & (a.slot_idx[real] < 97)).any())
    if case == "few_points":
        unbuilt = a.created[real] & ~a.built[real]
        assert bool(unbuilt.any()) and bool(a.built[real].any())
        assert bool((a.g_count[real][unbuilt] <= 2).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_pytorch_path_on_gpu(cuda_device, deterministic, case, dtype):
    """Scan after scan, one launch each, from the same map: the kernel's ids
    and integer and bool fields equal the PyTorch path's (deterministic) in
    every real row, and its float fields bit for bit in every real row whose
    open-slot sums the two add in the same order.  The deterministic
    ``index_add_`` sums a scan's beams of a cell first and then adds them to
    the open slot; the kernel adds them one by one, as ``index_add_`` does on
    the CPU.  The two orders differ only in a cell whose open slot held
    points before the scan and that two or more beams hit; there the map is
    held by test_kernel_adds_in_cpu_order_on_gpu and, through the poses, to
    the trajectory tolerance by test_node_steps_match_pytorch_path_on_gpu."""
    cfg, scans, prep = _scans(case, dtype)
    c = cfg.num_cells
    a = tmap.init_map(cfg, dtype, cuda_device)
    if prep is not None:
        prep(a)
    prev = torch.full((scans[0][1].shape[0],), c, dtype=torch.int32, device=cuda_device)
    for pose, pts, valid in (_to(s, cuda_device) for s in scans):
        b = _clone(a)
        held = a.cur_count[:c] > 0
        before = tni.ndt_ingest.LAUNCHES
        ids = tmap.ingest_scan(a, cfg, pose, pts, valid, prev)
        ids_b = tmap.ingest_scan_reference(b, cfg, pose, pts, valid, prev)
        torch.cuda.synchronize()
        assert tni.ndt_ingest.LAUNCHES == before + 1
        assert torch.equal(ids, ids_b)
        reordered = held & (torch.bincount(ids.long(), minlength=c + 1)[:c] >= 2)
        _assert_maps_equal(a, b, rows=c, floats_skip=reordered)
        prev = ids
    _check_case(case, a, prev, c, len(scans))


def _bins_agree(cfg, pose, pts):
    """Whether every beam's cell is the same binned by a division by the
    cell side (the CPU's) and by a product with its reciprocal (CUDA's and
    the kernel's); a NaN coordinate is NaN both ways."""
    q = transform_points(pts, pose) + cfg.half_size_m
    inv = torch.tensor(1.0, dtype=q.dtype) / torch.tensor(cfg.cell_side_m, dtype=q.dtype)
    div, mul = torch.floor(q / cfg.cell_side_m), torch.floor(q * inv)
    return bool(((div == mul) | (div.isnan() & mul.isnan())).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_adds_in_cpu_order_on_gpu(cuda_device, case, dtype):
    """The kernel's map equals the PyTorch path's on the CPU, where
    ``index_add_`` adds in index order, bit for bit in every real row, scan
    after scan: the order of the sums is the CPU's, which the CPU tests hold
    to the JAX package.  The poses' headings are set to 0, so cos and sin
    are exact on both devices.  A division by the cell side (the CPU's) and
    a product with its reciprocal (the kernel's) bin alike in dyadic cells,
    and in the 0.3 m case's wherever no beam lies within a rounding of a
    cell's edge, which is checked on each scan."""
    cfg, scans, prep = _scans(case, dtype)
    c = cfg.num_cells
    a = tmap.init_map(cfg, dtype, cuda_device)
    if prep is not None:
        prep(a)
    b = _to_cpu(a)
    prev_a = torch.full((scans[0][1].shape[0],), c, dtype=torch.int32, device=cuda_device)
    prev_b = prev_a.cpu()
    for pose, pts, valid in scans:
        pose = pose.clone()
        pose[2] = 0.0
        assert _bins_agree(cfg, pose, pts)
        prev_a = tmap.ingest_scan(a, cfg, *_to((pose, pts, valid), cuda_device), prev_a)
        prev_b = tmap.ingest_scan_reference(b, cfg, pose, pts, valid, prev_b)
        assert torch.equal(prev_a.cpu(), prev_b)
        _assert_maps_equal(_to_cpu(a), b, rows=c)
    _check_case(case, a, prev_a, c, len(scans))


@pytest.mark.gpu
def test_kernel_is_deterministic_on_gpu(cuda_device):
    """Two launches on the same map and scan give the same map, every row
    and bit."""
    cfg, scans, _ = _scans("patrol", torch.float32)
    state = tmap.init_map(cfg, torch.float32, cuda_device)
    prev = torch.full((N,), cfg.num_cells, dtype=torch.int32, device=cuda_device)
    for scan in scans[:-1]:
        prev = tmap.ingest_scan(state, cfg, *_to(scan, cuda_device), prev)
    a, b = _clone(state), _clone(state)
    last = _to(scans[-1], cuda_device)
    ids_a = tni.ndt_ingest(a, cfg, *last, prev)
    ids_b = tni.ndt_ingest(b, cfg, *last, prev)
    torch.cuda.synchronize()
    assert torch.equal(ids_a, ids_b)
    _assert_maps_equal(a, b)


@pytest.mark.gpu
def test_sparse_ring_takes_pytorch_ops_on_gpu(cuda_device):
    """On the card a sparse ring still takes the PyTorch ops: no launch."""
    cfg = dataclasses.replace(SMALL, window_slots=4, ring_rows=64)
    _, scans, _ = _scans("wrap", torch.float32)
    a = tmap.init_map(cfg, device=cuda_device)
    b = _clone(a)
    prev_a = prev_b = torch.full((60,), cfg.num_cells, dtype=torch.int32, device=cuda_device)
    before = tni.ndt_ingest.LAUNCHES
    for scan in scans:
        prev_a = tmap.ingest_scan(a, cfg, *_to(scan, cuda_device), prev_a)
        prev_b = tmap.ingest_scan_reference(b, cfg, *_to(scan, cuda_device), prev_b)
    torch.cuda.synchronize()
    assert tni.ndt_ingest.LAUNCHES == before
    assert torch.equal(prev_a, prev_b) and int(a.ring_used) > 0


@pytest.mark.gpu
def test_too_many_beams_raise_on_gpu(cuda_device):
    """A dense-ring scan of more beams than the kernel takes raises from
    ingest_scan on the card, with the map untouched: no other route."""
    n = tni.MAX_BEAMS + 1
    a = tmap.init_map(SMALL, device=cuda_device)
    b = _clone(a)
    before = tni.ndt_ingest.LAUNCHES
    with pytest.raises(ValueError, match=f"{n} beams"):
        tmap.ingest_scan(a, SMALL, torch.zeros(3, device=cuda_device),
                         torch.ones(n, 2, device=cuda_device),
                         torch.ones(n, dtype=torch.bool, device=cuda_device),
                         torch.full((n,), SMALL.num_cells, dtype=torch.int32, device=cuda_device))
    assert tni.ndt_ingest.LAUNCHES == before
    _assert_maps_equal(a, b)


@pytest.mark.gpu
def test_node_steps_match_pytorch_path_on_gpu(cuda_device, deterministic, monkeypatch):
    """50 node steps at scan.launch scale (300 m, 0.5 m, 100 slots, K1): one
    launch a step, and the poses within the card's trajectory tolerance of
    the same node with its map updated by the PyTorch ops."""
    from ndtpso_slam_tpu_torch.node import NodeConfig, SlamNode

    lg = tsynth.make_log(seed=2, n_scans=50, n_beams=360, world_size=50.0)
    ncfg = NodeConfig(frame_size_m=300.0, cell_side_m=0.5, window_slots=100,
                      pso_iterations=30, pso_population=50, max_beams=N,
                      cost_mode="rollout_local", init_pose=tuple(lg.poses[0]))

    def run(steps_launch):
        node = SlamNode(ncfg, verbose=False, device=cuda_device)
        for i in range(len(lg.ranges)):
            before = tni.ndt_ingest.LAUNCHES
            node.process_scan(lg.ranges[i], lg.angle_min, lg.angle_increment, lg.range_max,
                              timestamp=float(lg.timestamps[i]))
            assert tni.ndt_ingest.LAUNCHES - before == steps_launch, f"step {i}"
        return torch.as_tensor(node.poses)

    fused = run(1)
    monkeypatch.setattr(tmap, "ingest_scan", tmap.ingest_scan_reference)
    plain = run(0)
    torch.testing.assert_close(fused, plain, atol=TRAJ_ATOL, rtol=0)
    # chip_smoke.py phase 4's trajectory gate on the same log.
    err = np.hypot(*(fused.numpy()[:, :2] - lg.poses[:, :2]).T)
    assert err.mean() < 0.35 and err.max() < 0.7


@pytest.mark.gpu
def test_sessions_take_the_kernel_on_gpu(cuda_device):
    """run_offline_batch runs the solo step on views into the stacked state:
    one launch a session and scan, and each session's poses and map equal
    its solo run's bit for bit."""
    from ndtpso_slam_tpu_torch.models import slam as tslam

    cfg = tcfg.SlamConfig(pso=tcfg.PSOConfig(iterations=8, population=16),
                          map=tcfg.MapConfig(size_m=40.0, cell_side_m=0.5, window_slots=8),
                          scan=tcfg.ScanConfig(max_beams=192), cost_mode="rollout_local")
    logs = [tsynth.make_log(seed=s, n_scans=5, n_beams=180, world_size=30.0) for s in (3, 4)]
    loaded = [[tscan.load_laser(r, lg.angle_min, lg.angle_increment, lg.range_max, cfg.scan,
                                cfg.map, device=cuda_device) for r in lg.ranges] for lg in logs]
    scans = tscan.Scan(points=torch.stack([torch.stack([s.points for s in row]) for row in loaded]),
                       valid=torch.stack([torch.stack([s.valid for s in row]) for row in loaded]))
    init = np.stack([lg.poses[0] for lg in logs])
    keys = np.array([[1, 2], [3, 4]], np.uint32)
    before = tni.ndt_ingest.LAUNCHES
    states = tslam.init_slam_batch(cfg, init, cuda_device)
    states, poses, _ = tslam.run_offline_batch(states, scans, keys, cfg)
    torch.cuda.synchronize()
    assert tni.ndt_ingest.LAUNCHES - before == 2 * 5
    for i in range(2):
        solo = tslam.init_slam(cfg, tuple(init[i]), cuda_device)
        solo, solo_poses, _ = tslam.run_offline(
            solo, tscan.Scan(points=scans.points[i], valid=scans.valid[i]),
            (int(keys[i, 0]), int(keys[i, 1])), cfg)
        assert torch.equal(poses[i], solo_poses)
        for name, _, _ in tni.FIELDS:
            assert torch.equal(_bits(getattr(states.map, name)[i]),
                               _bits(getattr(solo.map, name))), name
