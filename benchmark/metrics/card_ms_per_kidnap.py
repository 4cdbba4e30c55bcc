"""card_ms_per_kidnap: the median, over the kidnap steps of the node's
untraced window at which the node accepted a relocalization, of the card's
busy time within the step, in ms: the union of every kernel, copy and set
that CUPTI recorded from the mark before the step to the mark before the
next (``ndtbench/cupti.py``).  What a user of recovery pays on the card each
time the robot is lost and found again.  The traffic puts the kidnaps
(``Context.events["kidnaps"]``); the work of such a step (the align, then
one relocalization: the pose grid, its NMS, two sets of swarms, the exact
rescoring) is set by the configuration, so neither how often the program
relocalizes after a kidnap nor how many kidnaps its align rides out moves
it.  The median, so a rare step with more or less work does not."""

import numpy as np


def read(ctx):
    busy, ev = ctx.step_busy_s, ctx.events
    if ctx.kind != "node" or busy is None or not ev:
        return None
    lo, accepted = ev["timed_from"], set(ev["accepted"])
    steps = [busy[t - lo] for t in ev["kidnaps"] if t in accepted and 0 <= t - lo < len(busy)]
    if not steps:
        return None
    return 1e3 * float(np.median(steps))
