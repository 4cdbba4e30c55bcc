"""node.scans_per_s: with ``--trace 1``, the scans the node completed in a
window of ``--seconds`` with nothing recorded, taken after the traced
windows, over that window's seconds: the node's rate on the host's clock,
which the host's own speed moves run to run."""


def read(ctx):
    if ctx.kind != "node" or ctx.trace is None or ctx.window_s <= 0:
        return None
    return len(ctx.durations) / ctx.window_s
