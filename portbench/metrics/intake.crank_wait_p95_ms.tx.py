"""intake.crank_wait_p95_ms.tx: the 95th percentile (nearest rank) of a
/tx request's wait for the node's crank loop, from the HTTP thread's
post_action to the start of its work there: the `wait_s` of the window's
`http.tx` spans, in ms."""

from portbench.lib import spans
from portbench.runners.validator import p95


def read(ctx):
    waits = [a["wait_s"] for _, _, a in spans.window_spans(ctx, "http.tx")
             or () if a.get("wait_s") is not None]
    return 1e3 * p95(waits) if waits else None
