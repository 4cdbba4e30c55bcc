"""k1.launch_us: the mean self time of the program's ``k1.launch`` span (K1's
ctypes wrapper: checks, cluster choice, scratch, key words, the call) per
launch in the node's device-only traced window, in us, CUPTI's cost on the
launch included (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    if ctx.kind != "node":
        return None
    return spans.self_us_per_span(ctx, "k1.launch")
