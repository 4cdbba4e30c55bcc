"""batch.kernels_per_call: device kernels (copies and sets not counted) per
``solve_batch`` call in the traced window."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.kind != "solve_batch" or not t.kernels:
        return None
    return len(t.kernels) / t.units
