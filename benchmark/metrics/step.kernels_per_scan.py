"""step.kernels_per_scan: device kernels (copies and sets not counted) per
scan in the traced window of the node."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.kind != "node" or not t.kernels:
        return None
    return len(t.kernels) / t.units
