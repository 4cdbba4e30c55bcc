"""solves_per_s: the solves of every call completed in the window over the
window's seconds."""


def read(ctx):
    if ctx.kind != "solve_batch" or ctx.trace is not None or ctx.window_s <= 0:
        return None
    return ctx.units * ctx.per_unit / ctx.window_s
