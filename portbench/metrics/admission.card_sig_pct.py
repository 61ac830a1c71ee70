"""admission.card_sig_pct: the share of the signatures of the transactions
submitted in the window that admission sent to the card
(herder.admission.sigs-offloaded), window deltas."""


def read(ctx):
    sigs = ctx.stats.get("submitted_signatures", 0)
    if sigs <= 0:
        return None
    return 100.0 * ctx.counter("herder.admission.sigs-offloaded") / sigs
