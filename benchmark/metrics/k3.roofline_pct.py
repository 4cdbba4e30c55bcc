"""k3.roofline_pct: K3's bound (the frozen ``score_bound`` at the traced
view's ``shape["k3"]``: the relocalization's B=K swarms) over its mean
device time per ``score_kernel`` launch in the traced window, in percent."""

from ndtbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None or "k3" not in t.shape:
        return None
    k3 = [d for name, _, d in t.kernels if "score_kernel" in name]
    if not k3:
        return None
    bound_ms, _ = roofline.score_bound(**t.shape["k3"])
    return 100.0 * bound_ms / (sum(k3) / len(k3) / 1e3)
