"""node.export_ms: the program's ``node.export`` span (the pose and every
n-th scan's points kept for the export bundle, ``utils/export.py``) per scan
of the node's device-only traced window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    return spans.self_ms_per_root(ctx, ("node.export",))
