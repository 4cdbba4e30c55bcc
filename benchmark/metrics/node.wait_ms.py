"""node.wait_ms: the program's ``node.pose_fetch`` span (the pose copied to
the host: the host waits there for the device to finish the step) per scan
of the node's device-only traced window, in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    return spans.self_ms_per_root(ctx, ("node.pose_fetch",))
