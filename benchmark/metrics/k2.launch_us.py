"""k2.launch_us: the mean self time of the program's ``k2.launch`` span (K2's
ctypes wrapper: checks, cluster choice, scratch, key words, the call) per
launch in the batch matcher's device-only traced window, in us, CUPTI's
cost on the launch included (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    if ctx.kind != "solve_batch":
        return None
    return spans.self_us_per_span(ctx, "k2.launch")
