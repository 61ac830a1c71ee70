"""catchup.bucket_apply_ms.catchup: mean ms of a pass's bucket apply
(CatchupManager.catchup_minimal: the checkpoint's buckets read, checked
and assumed): the `catchup.bucket-apply` timer, window deltas."""

from portbench.lib import spans


def read(ctx):
    return spans.timer_mean_ms(ctx, "catchup.bucket-apply")
