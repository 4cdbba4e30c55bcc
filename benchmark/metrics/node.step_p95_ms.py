"""node.step_p95_ms: with ``--trace 1``, the 95th percentile (numpy's
linear interpolation) of every step of the window with nothing recorded,
each a host clock around ``process_scan`` up to the pose on the host."""

import numpy as np


def read(ctx):
    if ctx.kind != "node" or ctx.trace is None or not ctx.durations:
        return None
    return float(np.percentile(np.asarray(ctx.durations) * 1e3, 95))
