"""On the card: each cell's command runs end to end, prints its result as
the last line of standard output with ``correct`` true, and the checks as
the last lines of standard error; the patrol cell turned into a node with
recovery on fed a kidnap log (``bench_small.KIDNAP``) runs at its published
widths, correct, with the relocalization's kernel (K3) in the traced
window; and the kidnap cell reads its three per-layer metrics and the
card's time per kidnap step above the patrol's per scan.  Marked ``gpu``;
skips without a card."""

import json
import subprocess
import sys
import time

import pytest

from bench_small import KIDNAP, ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("workload,trace", [("scan_launch.patrol", 0), ("batch_match.b256", 1),
                                            ("batch_match.b16", 0),
                                            ("scan_launch_recovery.kidnap", 0)])
def test_cell_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # The kidnap cell at the benchmark's run length: its metric and its
    # judge's event quartiles read the window's tens of kidnaps.
    seconds = "20" if workload == "scan_launch_recovery.kidnap" else "2"
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "3000000021", "--seconds", seconds, "--trace", str(trace)],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if workload == "scan_launch.patrol":
        # CUPTI's busy time over the window: positive, under 1.5 ms a scan
        # (the traced windows read 0.88-0.90 ms).
        assert 0 < result["metrics"]["card_ms_per_scan"]["value"] < 1.5
    if workload == "scan_launch_recovery.kidnap":
        assert set(result["metrics"]) == {"card_ms_per_kidnap", "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.gpu
def test_kidnap_on_the_card(monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndtbench import cell, harness

    seen = {}
    read = cell.read_metrics

    def spy(metrics, ctx):
        seen["ctx"] = ctx
        return read(metrics, ctx)

    monkeypatch.setattr(cell, "read_metrics", spy)
    r = harness.run_cell("scan_launch.patrol", 3000000023, 3.0, True, torch.device("cuda", 0),
                         time.perf_counter(), overrides=KIDNAP)
    assert r["correct"], r["checks"]
    assert {"event_score_gap_p75", "accept_differ_pct"} <= set(r["checks"])
    ctx = seen["ctx"]
    kidnaps, accepted = ctx.events["kidnaps"], set(ctx.events["accepted"])
    assert kidnaps and sum(k in accepted for k in kidnaps) >= 0.8 * len(kidnaps), ctx.events
    assert any("score_kernel" in name for name, _, _ in ctx.trace.kernels)
    assert ctx.trace.shape["k3"] == {"batch": 8, "n_pts": 384, "population": 128}


@pytest.mark.gpu
def test_kidnap_cell_metrics_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ndtbench import harness

    dev = torch.device("cuda", 0)
    r = harness.run_cell("scan_launch_recovery.kidnap", 3000000025, 3.0, True, dev,
                         time.perf_counter())
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == {"recovery.kernels_per_kidnap", "k3.roofline_pct", "recovery.step_p95_ms"}
    assert m["recovery.kernels_per_kidnap"] > 1000  # the relocalization's kernels
    assert 0 < m["k3.roofline_pct"] <= 100 and m["recovery.step_p95_ms"] > 0
    # Untraced: the card's time per kidnap step, above the patrol's per scan.
    kid = harness.run_cell("scan_launch_recovery.kidnap", 3000000024, 20.0, False, dev,
                           time.perf_counter())
    patrol = harness.run_cell("scan_launch.patrol", 3000000024, 2.0, False, dev,
                              time.perf_counter())
    assert kid["correct"] and patrol["correct"], (kid["checks"], patrol["checks"])
    kid_ms = kid["metrics"]["card_ms_per_kidnap"]["value"]
    assert kid_ms > patrol["metrics"]["card_ms_per_scan"]["value"], (kid_ms, patrol["metrics"])
