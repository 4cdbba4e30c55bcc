"""The precision control comes out not correct, and the program correct,
under the limits each cell's configuration states: the node's control is
the reference computed in bfloat16 in the node's place, batch matching's is
the program's own bf16 scoring path (``control_mode``).  At small sizes on
the CPU; on the card at the cells' sizes see ``readings.py``."""

import pytest

import bench_small


@pytest.mark.parametrize("workload", ["scan_launch.patrol", "batch_match.b256", "batch_match.b16"])
def test_program_is_correct(workload):
    r = bench_small.run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", ["scan_launch.patrol", "batch_match.b256", "batch_match.b16"])
def test_control_is_not_correct(workload):
    r = bench_small.run(workload, control=True)
    assert not r["correct"], r["checks"]
