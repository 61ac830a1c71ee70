"""What the readers of the program's own spans, timers and counters share
(stellar_core_tpu_torch.util.tracing).  A window in which the program's
trace buffer evicted spans (the `tracing.spans-evicted` counter moved)
reads None, never a partial value; so does a program that lacks what a
reader reads."""

from __future__ import annotations


def evicted(ctx) -> bool:
    return ctx.counter("tracing.spans-evicted") > 0


def timer_mean_ms(ctx, name: str):
    """Mean milliseconds of the timer `name` over the window (its sum over
    its count), or None."""
    n, s = ctx.timer(name)
    if n <= 0 or evicted(ctx):
        return None
    return 1e3 * s / n


def window_spans(ctx, name: str):
    """[(start_ns, end_ns, args), ...] of the program's spans `name` that
    overlap the device trace's window, clipped to it; None untraced, on
    eviction, or where the program has no spans_between."""
    t = ctx.trace
    if t is None or evicted(ctx):
        return None
    try:
        from stellar_core_tpu_torch.util.tracing import spans_between
    except ImportError:
        return None
    return spans_between(t.t0_ns, t.t1_ns, name)


def prep_ms_per_ksig(ctx):
    """CPU milliseconds of the verify entry's host prep (the
    `accel.ed25519.prep` timer: its thread's CPU seconds, so no wait for
    the GIL counts) per thousand signatures it took in
    (`accel.ed25519.{generic,table}-sigs` and `rejected-prep`)."""
    n, s = ctx.timer("accel.ed25519.prep")
    sigs = ctx.counter("accel.ed25519.generic-sigs") \
        + ctx.counter("accel.ed25519.table-sigs") \
        + ctx.counter("accel.ed25519.rejected-prep")
    if n <= 0 or sigs <= 0 or evicted(ctx):
        return None
    return 1e3 * s / (sigs / 1000)
