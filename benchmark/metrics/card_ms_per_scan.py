"""card_ms_per_scan: the card's busy time per scan over the node's whole
window: the union of every kernel, copy and set that CUPTI recorded in the
window (``ndtbench/cupti.py``), over the scans the node completed in it.
It is the share of a card one sensor's node takes, which sets how many
nodes one card can serve, and the host's speed does not move it."""


def read(ctx):
    if ctx.kind != "node" or ctx.card_busy_s is None or not ctx.units:
        return None
    return 1e3 * ctx.card_busy_s / ctx.units
