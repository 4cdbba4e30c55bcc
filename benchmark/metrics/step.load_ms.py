"""step.load_ms: the self time of the program's ``step.load`` span (the
scan's ranges to points on the device, ``models/scan.py:load_laser``) per
scan of the node's device-only traced window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    return spans.self_ms_per_root(ctx, ("step.load",))
