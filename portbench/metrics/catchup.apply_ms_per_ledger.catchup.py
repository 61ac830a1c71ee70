"""catchup.apply_ms_per_ledger.catchup: milliseconds of checkpoint apply a
replayed ledger, less the wait for the card's verdicts: the
`catchup.apply.checkpoint` timer's seconds (a checkpoint's first apply
crank to its last) less the `catchup.preverify.collect-wait` timer's,
window deltas, over the ledgers of the window's passes.  Both apply paths,
the Python close and the native engine, update both timers."""


def read(ctx):
    n, apply_s = ctx.timer("catchup.apply.checkpoint")
    _, wait_s = ctx.timer("catchup.preverify.collect-wait")
    ledgers = ctx.stats.get("ledgers_in_window", 0)
    if n <= 0 or ledgers <= 0:
        return None
    return 1e3 * (apply_s - wait_s) / ledgers
