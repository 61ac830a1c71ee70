"""host.gc_pause_pct.catchup: the share of the traced replay window that
the Python cyclic collector's passes took (the `process.gc-pause` timer's
seconds, window deltas, over the window)."""

from portbench.lib import spans


def read(ctx):
    n, s = ctx.timer("process.gc-pause")
    t = ctx.trace
    if n <= 0 or t is None or t.window_s <= 0 or spans.evicted(ctx):
        return None
    return 100.0 * s / t.window_s
