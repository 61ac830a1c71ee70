"""kernel.tables_roofline_pct.channels: the table-path verify kernel's
(K-T's) share of its roofline over the replay window: the least time of
the window's accel.ed25519.table-sigs (lib/peaks.py, 117,670 products a
signature, K-T's own count) over the summed device time of
verify_tables_kernel alone."""

from portbench.lib import peaks


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    kernel_s = sum(e - s for name, s, e in t.ops
                   if "verify_tables_kernel" in name) / 1e9
    sigs = ctx.counter("accel.ed25519.table-sigs")
    if kernel_s <= 0 or sigs <= 0:
        return None
    return 100.0 * peaks.least_verify_s(sigs) / kernel_s
