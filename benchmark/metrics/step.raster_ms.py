"""step.raster_ms: the self time of the program's ``step.raster`` span (the
occupancy raster's incremental update, ``models/occupancy.py``) per scan of
the node's device-only traced window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    return spans.self_ms_per_root(ctx, ("step.raster",))
