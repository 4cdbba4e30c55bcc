"""recovery.step_p95_ms: with ``--trace 1``, the 95th percentile (numpy's
linear interpolation) of the host time of the kidnap steps of the window
with nothing recorded at which the node accepted a relocalization (the
steps ``card_ms_per_kidnap`` reads; ``durations[t - timed_from]``), each a
host clock around ``process_scan`` up to the pose on the host: the step to
set against the sensor's 100 ms period."""

import numpy as np


def read(ctx):
    ev = ctx.events
    if ctx.kind != "node" or ctx.trace is None or not ev or not ctx.durations:
        return None
    lo, n, accepted = ev["timed_from"], len(ctx.durations), set(ev["accepted"])
    ms = [1e3 * ctx.durations[t - lo] for t in ev["kidnaps"] if t in accepted and 0 <= t - lo < n]
    if not ms:
        return None
    return float(np.percentile(ms, 95))
