"""admission.deadline_flush_pct.tx: the share of admission's batches that
the deadline flushed, of those flushed by size, deadline or drain
(`herder.admission.flush-{size,deadline,drain}`, window deltas)."""

from portbench.lib import spans


def read(ctx):
    deadline = ctx.counter("herder.admission.flush-deadline")
    total = deadline + ctx.counter("herder.admission.flush-size") \
        + ctx.counter("herder.admission.flush-drain")
    if total <= 0 or spans.evicted(ctx):
        return None
    return 100.0 * deadline / total
