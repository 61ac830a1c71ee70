"""accel.hot_no_slot_pct.channels: of the signatures whose key qualified
as hot, the share that found no table slot and went to K-G:
accel.ed25519.hot-no-slot over hot-no-slot plus accel.ed25519.table-sigs,
window deltas.  The use counts that make a key hot last as long as the
process, and the window replays the same ledgers pass after pass, so an
ordinary account's key turns hot after a few passes.  None from a program
without the counter."""


def read(ctx):
    if "accel.ed25519.hot-no-slot" not in ctx.registry:
        return None
    left = ctx.counter("accel.ed25519.hot-no-slot")
    total = left + ctx.counter("accel.ed25519.table-sigs")
    if total <= 0:
        return None
    return 100.0 * left / total
