"""accel.table_sig_pct.channels: the share of the signatures sent to the
card that went by the key tables (K-T): accel.ed25519.table-sigs over
table-sigs plus accel.ed25519.generic-sigs (K-G), window deltas."""


def read(ctx):
    table = ctx.counter("accel.ed25519.table-sigs")
    total = table + ctx.counter("accel.ed25519.generic-sigs")
    if total <= 0:
        return None
    return 100.0 * table / total
