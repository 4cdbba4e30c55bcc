"""batch.bind_pack_ms: the self time of the program's ``solve.bind`` and
``solve.pack`` spans (each solve's stencil gathered at its guess and packed
for K2, ``ops/rollout.py:solve_rollout_mode``) per ``solve_batch`` call of
the batch matcher's device-only traced window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    if ctx.kind != "solve_batch":
        return None
    return spans.self_ms_per_root(ctx, ("solve.bind", "solve.pack"))
