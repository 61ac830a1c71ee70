"""kernel.generic_roofline_pct.channels: the generic verify kernel's
(K-G's) share of its roofline over the replay window: the least time of
the window's accel.ed25519.generic-sigs (lib/peaks.py, each signature
counted at 117,670 products whatever kernel verifies it) over the summed
device time of verify_generic_kernel alone."""

from portbench.lib import peaks


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    kernel_s = sum(e - s for name, s, e in t.ops
                   if "verify_generic_kernel" in name) / 1e9
    sigs = ctx.counter("accel.ed25519.generic-sigs")
    if kernel_s <= 0 or sigs <= 0:
        return None
    return 100.0 * peaks.least_verify_s(sigs) / kernel_s
