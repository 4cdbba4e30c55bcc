"""step.bind_pack_ms: the self time of the program's ``solve.bind`` and
``solve.pack`` spans (the stencil gathered at the guess and packed for K1,
``ops/rollout.py:solve_rollout_mode``) per scan of the node's device-only
traced window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    if ctx.kind != "node":
        return None
    return spans.self_ms_per_root(ctx, ("solve.bind", "solve.pack"))
