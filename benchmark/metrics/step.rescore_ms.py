"""step.rescore_ms: the self time of the program's ``step.rescore`` span (the
exact NDT cost of the align's pose, ``models/slam.py:align``) per scan of
the node's device-only traced window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    return spans.self_ms_per_root(ctx, ("step.rescore",))
