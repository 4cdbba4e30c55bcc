"""recovery.kernels_per_kidnap: device kernels (copies and sets not
counted) per kidnap step of the node's device-only traced window at which
the node accepted a relocalization (the steps ``card_ms_per_kidnap``
reads): those that start within such a step's ``node.scan`` span, whose
request is the step (``ndtbench/spans.py``), over the steps found there.
The relocalization's kernels and the step's own."""

import numpy as np

from ndtbench import spans


def read(ctx):
    t, ev = ctx.trace, ctx.events
    if t is None or ctx.kind != "node" or not ev or not t.kernels:
        return None
    w = spans.window(ctx)
    if w is None:
        return None
    relocalized = set(ev["kidnaps"]) & set(ev["accepted"])
    steps = [(w.spans[i].start_us, w.spans[i].end_us) for i in w.roots
             if w.spans[i].request in relocalized]
    if not steps:
        return None
    starts = np.sort(np.asarray([s for _, s, _ in t.kernels]))
    inside = sum(int(np.searchsorted(starts, e) - np.searchsorted(starts, s)) for s, e in steps)
    return inside / len(steps)
