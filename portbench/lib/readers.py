"""The arithmetic of the per-layer metrics, shared by the readers in
portbench/metrics/.  Each returns None where the window holds nothing to
read, never 0 in place of a missing share."""

from __future__ import annotations

from . import peaks
from . import trace as tr


def close_ms(ctx):
    """Mean milliseconds of the port's ledger closes in the window (the
    `ledger.ledger.close` timer's sum and count)."""
    n, s = ctx.timer("ledger.ledger.close")
    return 1e3 * s / n if n else None


def idle_pct(ctx):
    """100% less the share of the traced window in which some device
    operation (kernel, copy or set) ran."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.union_s(t.ops) / t.window_s)


def verify_roofline_pct(ctx):
    """The least time of the signatures sent to the card in the window
    (peaks.least_verify_s) over the summed device time of the verify
    kernels in the trace."""
    t = ctx.trace
    if t is None:
        return None
    kernel_s = sum(e - s for name, s, e in t.ops
                   if any(k in name for k in peaks.VERIFY_KERNELS)) / 1e9
    sigs = ctx.counter("accel.ed25519.generic-sigs") \
        + ctx.counter("accel.ed25519.table-sigs")
    if kernel_s <= 0 or sigs <= 0:
        return None
    return 100.0 * peaks.least_verify_s(sigs) / kernel_s
