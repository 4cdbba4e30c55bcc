"""``ndtbench/spans.py`` and the span readers on a made-up traced window:
the window's spans chosen by the device operations' range, self times of
nested spans, the division per scan, call or launch, and None wherever no
span is found."""

from collections import namedtuple

import pytest

import bench_small  # noqa: F401  (puts the benchmark on sys.path)
from ndtbench import cell, harness, spans as S, trace as T

Span = namedtuple("Span", "name request parent thread start_us end_us")

NODE_READERS = ("step.load_ms", "step.bind_pack_ms", "k1.launch_us", "step.rescore_ms",
                "step.map_ms", "step.raster_ms", "node.wait_ms", "node.export_ms",
                "node.other_ms")
BATCH_READERS = ("batch.host_ms", "batch.bind_pack_ms", "k2.launch_us")


def _ctx(kind, device_ops):
    view = T.View(kind=kind, units=2, window_s=1.0, plain_s=1.0, busy_s=0.0, kernels=[],
                  device_ops=device_ops, shape={}, tries=1, breakdown={})
    return harness.Context(kind=kind, units=2, per_unit=1, durations=[], window_s=1.0,
                           setup_s=1.0, trace=view)


def _scan(out, step, t0):
    """One node.scan tree starting at t0 us, 100 us long: (name, parent
    name, start offset, end offset)."""
    tree = [("node.scan", None, 0, 100), ("step.load", "node.scan", 1, 5),
            ("step.align", "node.scan", 6, 60), ("solve.bind", "step.align", 7, 17),
            ("solve.pack", "step.align", 18, 23), ("k1.launch", "step.align", 24, 34),
            ("step.rescore", "step.align", 35, 55), ("step.map_update", "node.scan", 61, 66),
            ("step.map_build", "node.scan", 66, 72), ("step.raster", "node.scan", 73, 80),
            ("node.pose_fetch", "node.scan", 81, 95), ("node.export", "node.scan", 95, 99)]
    index = {}
    for name, parent, a, b in tree:
        index[name] = len(out)
        out.append(Span(name, step, index[parent] if parent else -1, 1, t0 + a, t0 + b))


def _two_windows():
    """Two scans in the device window [1000, 1200] us, one after it (the
    host-traced window) and one before it (a window taken again)."""
    out = []
    for step, t0 in ((0, 500.0), (1, 1000.0), (2, 1100.0), (3, 2000.0)):
        _scan(out, step, t0)
    return out


DEVICE = [("k", 1030.0, 10.0), ("k", 1190.0, 5.0)]


def test_window_takes_the_roots_over_the_device_range():
    w = S.window(_ctx("node", DEVICE), _two_windows())
    assert [w.spans[i].request for i in w.roots] == [1, 2]
    assert {w.spans[i].request for i in w.self_us} == {1, 2}
    assert S.window(_ctx("node", [("k", 3000.0, 1.0)]), _two_windows()) is None
    assert S.window(_ctx("node", []), _two_windows()) is None


def test_self_times_of_nested_spans():
    w = S.window(_ctx("node", DEVICE), _two_windows())
    by = {w.spans[i].name: w.self_us[i] for i in w.self_us if w.spans[i].request == 1}
    assert by["step.align"] == pytest.approx(54 - 10 - 5 - 10 - 20)
    assert by["node.scan"] == pytest.approx(100 - 4 - 54 - 5 - 6 - 7 - 14 - 4)
    assert by["solve.bind"] == pytest.approx(10)
    # Overlapping children are counted once.
    sp = [Span("r", 0, -1, 1, 0.0, 10.0), Span("a", 0, 0, 1, 1.0, 5.0),
          Span("b", 0, 0, 1, 3.0, 7.0)]
    w = S.Window(sp, "r", 0.0, 10.0)
    assert w.self_us[0] == pytest.approx(4.0)


def test_per_unit_division():
    ctx, sp = _ctx("node", DEVICE), _two_windows()
    assert S.self_ms_per_root(ctx, ("solve.bind", "solve.pack"), sp) == pytest.approx(15e-3)
    assert S.self_us_per_span(ctx, "k1.launch", sp) == pytest.approx(10.0)
    assert S.root_ms(ctx, sp) == pytest.approx(0.1)
    assert S.self_ms_per_root(ctx, ("k2.launch",), sp) is None


def test_node_readers_sum_to_the_scan(monkeypatch):
    monkeypatch.setattr(S, "recorded", _two_windows)
    ctx = _ctx("node", DEVICE)
    got = {m: cell.reader(m)(ctx) for m in NODE_READERS}
    total = sum(v for m, v in got.items() if m != "k1.launch_us") + got["k1.launch_us"] / 1e3
    assert total == pytest.approx(S.root_ms(ctx))
    assert all(cell.reader(m)(ctx) is None for m in BATCH_READERS)


def test_batch_readers(monkeypatch):
    sp = []
    for call, t0 in ((7, 100.0), (8, 200.0)):
        sp.append(Span("batch.call", call, -1, 1, t0, t0 + 40))
        root = len(sp) - 1
        sp += [Span("solve.bind", call, root, 1, t0 + 1, t0 + 11),
               Span("solve.pack", call, root, 1, t0 + 12, t0 + 14),
               Span("k2.launch", call, root, 1, t0 + 15, t0 + 35)]
    monkeypatch.setattr(S, "recorded", lambda: sp)
    ctx = _ctx("solve_batch", [("k", 120.0, 100.0)])
    got = {m: cell.reader(m)(ctx) for m in BATCH_READERS}
    assert got == pytest.approx({"batch.host_ms": 0.04, "batch.bind_pack_ms": 0.012,
                                 "k2.launch_us": 20.0})
    assert all(cell.reader(m)(ctx) is None for m in NODE_READERS)


@pytest.mark.parametrize("metric", NODE_READERS + BATCH_READERS)
def test_readers_find_nothing_without_spans(metric):
    from ndtpso_slam_tpu_torch.utils import profiling

    profiling.clear()
    read = cell.reader(metric)
    for kind in ("node", "solve_batch"):
        assert read(_ctx(kind, DEVICE)) is None
        assert read(harness.Context(kind=kind, units=0, per_unit=1, durations=[],
                                    window_s=0.0, setup_s=0.0, trace=None)) is None


def _kidnap_view(kernels, shape):
    view = T.View(kind="node", units=4, window_s=1.0, plain_s=1.0, busy_s=0.0, kernels=kernels,
                  device_ops=kernels, shape=shape, tries=1, breakdown={})
    return harness.Context(kind="node", units=4, per_unit=1, durations=[], window_s=1.0,
                           setup_s=1.0, trace=view,
                           events={"kidnaps": [1, 3], "accepted": [1, 2, 3], "timed_from": 5})


def test_kernels_per_kidnap_counts_within_kidnap_steps(monkeypatch):
    sp = []
    for step, t0 in ((0, 500.0), (1, 1000.0), (2, 1100.0), (3, 1200.0), (4, 1300.0)):
        _scan(sp, step, t0)
    monkeypatch.setattr(S, "recorded", lambda: sp)
    # Steps 1 and 3 are kidnaps; step 0 lies before the device window.
    starts = [1001.0, 1050.0, 1099.5, 1100.0, 1150.0, 1200.0, 1210.0, 1220.0, 1299.0, 1301.0]
    ctx = _kidnap_view([("k", s, 0.5) for s in starts], {})
    read = cell.reader("recovery.kernels_per_kidnap")
    assert read(ctx) == pytest.approx((3 + 4) / 2)
    # A kidnap step without an accepted relocalization is not read.
    ctx.events = dict(ctx.events, accepted=[2, 3])
    assert read(ctx) == pytest.approx(4)
    ctx.events = dict(ctx.events, kidnaps=[0, 7])  # none in the window
    assert read(ctx) is None
    ctx.events = None
    assert read(ctx) is None
    monkeypatch.setattr(S, "recorded", lambda: [])
    assert read(_kidnap_view([("k", s, 0.5) for s in starts], {})) is None


def test_k3_roofline_is_the_bound_over_the_mean_launch():
    from ndtbench import roofline

    k3 = dict(batch=8, n_pts=384, population=128)
    kernels = [("void (anonymous namespace)::score_kernel<15, 4>(float const*)", 10.0, 40.0),
               ("void (anonymous namespace)::score_kernel<15, 4>(float const*)", 60.0, 60.0),
               ("void rollout_local_kernel<1u>(...)", 200.0, 150.0)]
    read = cell.reader("k3.roofline_pct")
    bound_ms, _ = roofline.score_bound(**k3)
    assert read(_kidnap_view(kernels, {"k3": k3})) == pytest.approx(100 * bound_ms / 0.05)
    assert read(_kidnap_view(kernels, {})) is None  # recovery off: no K3 shape
    assert read(_kidnap_view(kernels[2:], {"k3": k3})) is None  # no K3 launch
    no_trace = _kidnap_view(kernels, {"k3": k3})
    no_trace.trace = None
    assert read(no_trace) is None
