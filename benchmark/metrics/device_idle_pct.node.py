"""device_idle_pct.node: the share of the node's untraced window in
which no device operation (kernel, copy or set) runs, in percent: the
device-only trace's busy time over the same scans or calls untraced."""

from ndtbench.trace import idle_pct as read  # noqa: F401
