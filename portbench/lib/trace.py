"""The device timeline of a traced window, from torch.profiler: which
device operations ran when, the union of their intervals (the seconds the
card was busy), the time by operation, and the longest idle gaps labelled
by what the host was doing then."""

from __future__ import annotations

import time


class DeviceTrace:
    """Profile the device: start() ... stop() on the main thread (the
    profiler initialises there), then `ops`, a list of (name, start_ns,
    end_ns) device operations (kernels, copies, sets) clipped to the
    window.  The window runs from start() to stop(), or between open() and
    close() where another thread marks it inside them."""

    def __init__(self):
        self.ops, self.t0_ns, self.t1_ns = [], None, None
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0_ns = time.time_ns()

    def open(self) -> None:
        self.t0_ns = time.time_ns()

    def close(self) -> None:
        self.t1_ns = time.time_ns()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        if self.t1_ns is None:
            self.t1_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA":
                continue
            start = e.start_ns()
            s, t = max(start, self.t0_ns), min(start + e.duration_ns(),
                                               self.t1_ns)
            if s < t:
                ops.append((e.name(), s, t))
        ops.sort(key=lambda o: o[1])
        self.ops = ops
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def union_s(ops) -> float:
    """Seconds covered by the union of the ops' intervals."""
    total, end = 0, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def op_seconds(ops, top: int = 10) -> list:
    """[[name, seconds], ...] of the device operations that took most
    time, summed by name."""
    by = {}
    for name, s, e in ops:
        by[name] = by.get(name, 0) + (e - s)
    return [[n, ns / 1e9] for n, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(ops, t0_ns: int, t1_ns: int, spans, other: str,
              top: int = 10) -> list:
    """[[name, seconds], ...]: the window's idle device time split by what
    the host was doing: the part of each gap that `spans` ((start_ns,
    end_ns, name) host intervals, not overlapping) cover goes to their
    names, the rest to `other`; the largest first."""
    spans = sorted(spans)
    by, at = {}, t0_ns
    for _, s, e in sorted(ops, key=lambda o: o[1]) + [("", t1_ns, t1_ns)]:
        if s > at:
            covered = 0
            for a, b, name in spans:
                lo, hi = max(a, at), min(b, s)
                if lo < hi:
                    by[name] = by.get(name, 0) + (hi - lo)
                    covered += hi - lo
            by[other] = by.get(other, 0) + (s - at - covered)
        at = max(at, e)
    return [[n, ns / 1e9] for n, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:top] if ns > 0]


def innermost(levels) -> list:
    """Flatten lists of (start_ns, end_ns, name) host spans, given
    innermost first, into intervals none of which overlap, as idle_gaps
    takes them: each span keeps only the part that no span before it (of
    its own list or an inner one) covers."""
    covered, out = [], []
    for spans in levels:
        for s, e, name in sorted(spans):
            at = s
            for a, b in covered:
                if b <= at:
                    continue
                if a >= e:
                    break
                if a > at:
                    out.append((at, a, name))
                at = max(at, b)
            if at < e:
                out.append((at, e, name))
            covered = _merged(covered + [(s, e)])
    return sorted(out)


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
