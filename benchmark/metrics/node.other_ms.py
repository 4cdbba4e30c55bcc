"""node.other_ms: the self time of the program's ``node.scan`` and
``step.align`` spans (what no leaf span of the step covers: the key, the
map's snapshot, the deviation, the fitness) per scan of the node's
device-only traced window, in ms.  With the other eight node metrics (K1's
launches as ms per scan) it sums to the mean ``node.scan``
(``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    return spans.self_ms_per_root(ctx, ("node.scan", "step.align"))
