"""call_p95_ms: the 95th percentile (numpy's linear interpolation) of every
``solve_batch`` call of the window, each up to its poses and costs on the
host."""

import numpy as np


def read(ctx):
    if ctx.kind != "solve_batch" or not ctx.durations:
        return None
    return float(np.percentile(np.asarray(ctx.durations) * 1e3, 95))
