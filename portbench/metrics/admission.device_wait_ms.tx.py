"""admission.device_wait_ms.tx: mean ms the crank loop waited in a card
batch's collect for its verdicts: the `herder.admission.device-wait`
timer, window deltas."""

from portbench.lib import spans


def read(ctx):
    return spans.timer_mean_ms(ctx, "herder.admission.device-wait")
