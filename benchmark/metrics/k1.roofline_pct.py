"""k1.roofline_pct: K1's bound (the frozen ``rollout_local_bound`` at the
launch's shape, every iteration live) over its mean device time per launch
in the traced window, in percent."""

from ndtbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    k1 = [d for name, _, d in t.kernels if "rollout_local" in name]
    if not k1:
        return None
    s = t.shape
    bound_ms, _ = roofline.rollout_local_bound(s["batch"], s["n_pts"], s["population"],
                                               [s["iterations"]] * s["batch"])
    return 100.0 * bound_ms / (sum(k1) / len(k1) / 1e3)
