"""Loads a TPU script under experiments/ without running it, for the
port's tests (test_torch_probes.py, test_torch_rollout_bisect.py).

io_probe.py, mosaic_probe.py and rollout_bisect.py run their kernels when
they are imported, so the tests load them through their syntax trees
instead: imports, function definitions and assignments, no top-level
calls.  Nothing under experiments/ changes.  ``load_script`` needs no JAX
itself; the scripts' own imports do.
"""

import ast
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def load_script(name, drop=()):
    """A TPU script under experiments/ without its top-level work: its
    imports, function definitions and assignments, less the assignments to
    the names in ``drop``."""
    path = ROOT / "experiments" / f"{name}.py"
    keep = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            keep.append(node)
        elif isinstance(node, ast.Assign) and not any(
                isinstance(t, ast.Name) and t.id in drop for t in node.targets):
            keep.append(node)
    mod = types.ModuleType(f"tpu_script_{name}")
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), mod.__dict__)
    return mod


@pytest.mark.parametrize("name, drop, has, dropped", [
    ("io_probe", ("which",), ("k_min", "k_smem", "k_sten3", "k_sten4", "keys"), "which"),
    ("mosaic_probe", (), ("run", "k_col3", "k_bcast_out", "x", "xi"), None),
    ("rollout_bisect", ("stage",), ("make_kernel", "run", "B", "N"), "stage"),
])
def test_load_script_keeps_the_definitions_and_runs_nothing(name, drop, has, dropped):
    """The script's functions and constants load; the top-level work does
    not run (rollout_bisect.py would parse sys.argv[1] as a stage) and the
    dropped names are not assigned."""
    pytest.importorskip("jax", reason="the TPU scripts import JAX")
    mod = load_script(name, drop)
    assert all(hasattr(mod, a) for a in has)
    assert dropped is None or not hasattr(mod, dropped)
