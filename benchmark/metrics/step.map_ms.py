"""step.map_ms: the self time of the program's ``step.map_update`` (the scan
binned into its cells and added to the map) and ``step.map_build`` (the
touched cells rebuilt) spans per scan of the node's device-only traced
window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    return spans.self_ms_per_root(ctx, ("step.map_update", "step.map_build"))
