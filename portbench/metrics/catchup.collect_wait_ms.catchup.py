"""catchup.collect_wait_ms.catchup: mean ms a preverify collect waited for
its group's verdicts: the `catchup.preverify.collect-wait` timer, window
deltas."""

from portbench.lib import spans


def read(ctx):
    return spans.timer_mean_ms(ctx, "catchup.preverify.collect-wait")
