"""batch.host_ms: the mean duration of the program's ``batch.call`` span (one
``solve_batch`` call on the host, up to its launch returning; the poses
are not yet on the host) in the batch matcher's device-only traced window,
in ms (``ndtbench/spans.py``)."""

from ndtbench import spans


def read(ctx):
    if ctx.kind != "solve_batch":
        return None
    return spans.root_ms(ctx)
