"""admission.collect_ms.tx: mean ms of one admission collect action on the
crank loop (a batch's device collect, then try_add of each of its frames):
the `herder.admission.collect` timer, window deltas."""

from portbench.lib import spans


def read(ctx):
    return spans.timer_mean_ms(ctx, "herder.admission.collect")
