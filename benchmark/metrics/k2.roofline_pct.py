"""k2.roofline_pct: K2's bound (the frozen ``rollout_bound``, float32, all
iterations live: the cell runs no early exit) over its mean device time per
launch in the traced window, in percent."""

from ndtbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    k2 = [d for name, _, d in t.kernels if "rollout_kernel" in name]
    if not k2:
        return None
    s = t.shape
    bound_ms, _ = roofline.rollout_bound(s["batch"], s["n_pts"], s["population"],
                                         [s["iterations"]] * s["batch"])
    return 100.0 * bound_ms / (sum(k2) / len(k2) / 1e3)
