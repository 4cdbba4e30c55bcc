"""With the timed path broken underneath, a run comes out not correct: once
for each fault a cell can have (a step that returns its state unchanged; an
answer altered where it is produced, in every step or call or in one of
five, which leaves the percentiles at rounding and shows in
``parted_pct``; half of a batch left out).  The runs skip the look for a
chip and run at small sizes on the CPU."""

import pytest
import torch

import bench_small  # noqa: F401

ALTER_M = 0.2  # an answer moved by this much is plainly wrong
EVERY = 5  # the sparse faults alter one step or call in this many
BATCH_CALLS = 40  # a batch window of this many calls, all of them sampled


def fixed_window(monkeypatch, calls):
    """The window as ``calls`` calls, however fast the CPU runs them: with
    every call of it sampled, exactly one in ``EVERY`` is a sparse fault's."""
    import time

    from ndtbench import drivers

    def timed(step, seconds):
        durations = []
        for _ in range(calls):
            t = time.perf_counter()
            step()
            durations.append(time.perf_counter() - t)
        return durations, sum(durations)

    monkeypatch.setattr(drivers, "timed", timed)


def test_node_step_state_unchanged(monkeypatch):
    from ndtpso_slam_tpu_torch.models import slam

    def stuck(state, scan, key, cfg):
        return state, state.pose, torch.zeros((), dtype=state.pose.dtype)

    monkeypatch.setattr(slam, "slam_step", stuck)
    r = bench_small.run("scan_launch.patrol")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("every", [1, EVERY])
def test_node_pose_altered(monkeypatch, every):
    from ndtpso_slam_tpu_torch.models import slam

    solve, calls = slam.solve_rollout_mode, []

    def altered(*args, **kwargs):
        pose, cost = solve(*args, **kwargs)
        calls.append(1)
        if len(calls) % every:
            return pose, cost
        return pose + torch.tensor([ALTER_M, 0.0, 0.0], device=pose.device), cost

    monkeypatch.setattr(slam, "solve_rollout_mode", altered)
    r = bench_small.run("scan_launch.patrol", seconds=2.0, more={"traffic": {"sample_steps": 40}})
    assert not r["correct"], r["checks"]
    assert r["checks"]["parted_pct"]["value"] > r["checks"]["parted_pct"]["limit"]


@pytest.mark.parametrize("workload", ["batch_match.b256", "batch_match.b16"])
def test_batch_half_left_out(monkeypatch, workload):
    from ndtpso_slam_tpu_torch.parallel import mesh

    solve = mesh.solve_rollout_mode

    def half(mode, keys, guesses, devs, snaps, points, valid, *rest):
        h = keys.shape[0] // 2
        cut = lambda t: t[:h]
        snaps = type(snaps)(*(cut(f) for f in (snaps.mean, snaps.inv_cov, snaps.built)))
        pose, cost = solve(mode, cut(keys), cut(guesses), cut(devs), snaps, cut(points),
                           cut(valid), *rest)
        return torch.cat([pose, pose]), torch.cat([cost, cost])

    monkeypatch.setattr(mesh, "solve_rollout_mode", half)
    fixed_window(monkeypatch, BATCH_CALLS)
    r = bench_small.run(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("every", [1, EVERY])
@pytest.mark.parametrize("workload", ["batch_match.b256", "batch_match.b16"])
def test_batch_answer_altered(monkeypatch, workload, every):
    from ndtpso_slam_tpu_torch.parallel import mesh

    solve, calls = mesh.solve_rollout_mode, []

    def altered(*args):
        pose, cost = solve(*args)
        calls.append(1)
        if len(calls) % every:
            return pose, cost
        return pose + torch.tensor([ALTER_M, 0.0, 0.0], device=pose.device), cost

    monkeypatch.setattr(mesh, "solve_rollout_mode", altered)
    fixed_window(monkeypatch, BATCH_CALLS)
    r = bench_small.run(workload, more={"traffic": {"sample_solves": BATCH_CALLS}})
    assert not r["correct"], r["checks"]
    assert r["checks"]["parted_pct"]["value"] > r["checks"]["parted_pct"]["limit"]
