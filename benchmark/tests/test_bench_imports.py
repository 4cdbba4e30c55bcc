"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Module names are compared by their
top-level name as a whole (the program's package name begins with the JAX
package's), each check in a fresh interpreter."""

import json
import subprocess
import sys

import pytest

from bench_small import BENCH, CELLS, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ndtpso_slam_tpu"}
PROGRAM = "ndtpso_slam_tpu_torch"

_CELL = """
import json, sys
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
import bench_small
r = bench_small.run({workload!r}, control={control}, trace={trace}, more={more})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import importlib, pathlib
from ndtbench import judge, reference, roofline, synthetic
for f in sorted(pathlib.Path({bench!r}, "metrics").glob("*.py")):
    from ndtbench import cell
    cell.reader(f.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("workload,control,trace,more", [
    ("scan_launch.patrol", False, False, None), ("scan_launch.patrol", True, True, None),
    ("scan_launch.patrol", False, False, "KIDNAP"),
    ("scan_launch_recovery.kidnap", False, True, None), ("batch_match.b256", False, True, None),
    ("batch_match.b16", True, False, None)])
def test_cell_loads_no_jax(workload, control, trace, more):
    assert workload in CELLS
    more = f"bench_small.{more}" if more else None
    tops = _tops(_CELL.format(bench=str(BENCH), tests=str(BENCH / "tests"), root=str(ROOT),
                              workload=workload, control=control, trace=trace, more=more))
    assert PROGRAM in tops  # the run did drive the program
    assert not tops & FORBIDDEN


def test_reference_and_readers_load_nothing_of_the_program():
    tops = _tops(_REFERENCE.format(bench=str(BENCH), root=str(ROOT)))
    assert "torch" in tops
    assert PROGRAM not in tops
    assert not tops & FORBIDDEN


def test_harness_checks_whole_names():
    import bench_small  # noqa: F401
    from ndtbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["ndtpso_slam_tpu_torch_x"] = sys
        sys.modules.pop("jax", None)
        assert "ndtpso_slam_tpu" not in harness.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
