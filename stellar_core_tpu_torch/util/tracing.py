"""Hierarchical span tracing with Chrome trace-event export.

Reference shape: the reference's LogSlowExecution + medida timers only
aggregate; this module keeps the *structure* of recent hot operations —
a ledger close is `ledger.close` > `ledger.tx-apply` > one `tx.apply` per
transaction; a catchup crank is `catchup.apply-checkpoint` above all of
that — so an operator can open one slow close in `chrome://tracing` (or
`ui.perfetto.dev`) instead of inferring shape from percentiles.

Design:
- `span("name", key=value)` is a context manager; the current span is
  context-local (contextvars), so nesting is automatic and thread/async
  safe — each thread traces its own tree.  `timed_span` also updates the
  metrics registry's timer of the same name.
- finished ROOT spans land in a buffer bounded in spans, roots and their
  trees counted alike (newest kept; what is evicted is counted in the
  `tracing.spans-evicted` counter); child spans attach to their parent
  and cost two perf_counter calls + one object.
- spans are stamped with perf_counter and mapped onto the time_ns clock
  through a perf/wall pair read when they are exported or read
  (util.clock.perf_wall_pair), so they line up with any other time_ns
  timeline, a device trace's included.  `spans_between` gives the spans
  of one name in a time_ns window.
- `to_chrome_trace()` renders the buffer as Chrome trace-event JSON
  (`{"traceEvents": [...]}`, "X" complete events, microsecond units);
  `dump_trace(path)` writes it to a file; the `/trace` admin endpoint
  serves it over HTTP.

Tracing is always on: the buffer is bounded in ALL dimensions —
TRACE_BUFFER_SPANS spans, MAX_CHILD_SPANS leaves per span, and
MAX_TREE_SPANS leaves per root tree (the elided tail is counted in each
span's `truncated_children` arg).  Only leaves are elided: a root, or a
span with children of its own, is always kept, so a pass's closes survive
when their `tx.apply` leaves do not.  Span overhead is far below the
operations instrumented (ledger close, checkpoint download, bucket
merge).  The process's collector pauses are timed too (`process.gc-pause`,
install_gc_pause_timer), its full passes counted (`process.gc-full`).
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics
from .clock import perf_wall_pair, wall_now
from .lockorder import make_lock

# Spans the buffer keeps, roots and their trees alike.  Measured on the
# benchmark's 50 s windows (portbench, an H100 host): catchup-pubnet
# 24,046-25,336 spans (93-98 closes of 1,000 payments, each keeping 256
# tx.apply leaves; 5.6-5.9 MB held at the window's end), tx-steady
# 10,659-10,823 (7,878-7,970 http.tx roots, ten closes, admission's
# collects; 4.7 MB).  This holds either window more than twice over,
# 15-27 MB when full, by the mix of spans.
TRACE_BUFFER_SPANS = 65_536
# Per-parent leaf cap: a replay crank can hold thousands of tx.apply
# leaves per ledger; beyond this the tail is elided (the span records how
# many were dropped).  256 leaves is more than chrome://tracing is
# readable at anyway.
MAX_CHILD_SPANS = 256
# Leaf budget per root tree: the per-parent cap alone is multiplicative
# (64 ledgers x 256 leaves each), so a whole tree's leaves are also
# budgeted — once exhausted, further leaves are elided and counted in
# their parent's truncated tally.
MAX_TREE_SPANS = 2048

_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("stpu_current_span", default=None)
# kept leaves of the current root tree ([n] so children mutate in place)
_tree_leaves: contextvars.ContextVar[Optional[list]] = \
    contextvars.ContextVar("stpu_tree_leaves", default=None)

# shared export sequence over phase marks AND finished root spans: an
# incremental consumer (/tracespans?since=) names one watermark and gets
# exactly the new data of both kinds (GIL-atomic counter)
_EXPORT_SEQ = itertools.count(1)

# Phase-mark ring capacity: a 5-node soak emits ~6 marks/slot/node; 4096
# covers hundreds of slots between collector scrapes.
MARK_BUFFER_MARKS = 4096


def clock_anchor(pair: Optional[Tuple[int, int]] = None) -> dict:
    """A fresh monotonic↔wall pairing for this process: perf_counter and
    the time_ns wall clock read as one pair (util.clock.perf_wall_pair),
    or `pair` itself.  A cross-node collector uses the pair to map each
    node's perf-epoch timestamps onto one wall timebase (util/fleettrace
    aligns residual wall skew via matched slot marks)."""
    perf_ns, wall_ns = pair or perf_wall_pair()
    return {"perf_s": perf_ns / 1e9, "wall_s": wall_ns / 1e9}


def _wall_ns(perf_s: float, pair: Tuple[int, int]) -> int:
    """A perf_counter stamp on the time_ns clock, through `pair`."""
    return pair[1] + round(perf_s * 1e9) - pair[0]

# process-unique span ids (GIL-atomic counter).  The id is what a
# structured log line carries (util/logging LOG_FORMAT=json) so a slow
# span can be joined against every record it emitted.
_SPAN_IDS = itertools.count(1)


class Span:
    __slots__ = ("name", "start_s", "dur_s", "args", "children", "tid",
                 "truncated", "leaves", "span_id", "parent", "export_seq")

    def __init__(self, name: str, args: Optional[Dict] = None,
                 parent: Optional["Span"] = None):
        self.name = name
        self.start_s = time.perf_counter()
        self.dur_s: Optional[float] = None
        self.args = args or None
        self.children: List["Span"] = []
        self.tid = threading.get_ident()
        self.truncated = 0  # leaves elided past MAX_CHILD_SPANS
        self.leaves = 0     # leaves kept among the children
        self.span_id = f"{next(_SPAN_IDS):x}"
        self.parent = parent
        self.export_seq: Optional[int] = None  # set when a root is recorded

    def finish(self) -> None:
        self.dur_s = time.perf_counter() - self.start_s  # corelint: owned-by=span-opener -- set by the thread that opened the span, before the buffer's lock publishes its tree

    def depth(self) -> int:
        """Nesting levels including self (a leaf is 1)."""
        return 1 + max((c.depth() for c in self.children), default=0)

    def size(self) -> int:
        """Spans in this tree, self included."""
        n, stack = 0, [self]
        while stack:
            s = stack.pop()
            n += 1
            stack.extend(s.children)
        return n

    def to_dict(self) -> dict:
        return {"name": self.name, "start_s": self.start_s,
                "dur_s": self.dur_s, "args": self.args,
                "children": [c.to_dict() for c in self.children]}


class _RegistryCounter:
    """One counter of the process registry, looked up again only when
    reset_registry() has swapped the registry (one `is` a use)."""

    def __init__(self, name: str):
        self.name, self._reg, self._counter = name, None, None

    def inc(self, n: int = 1) -> None:
        reg = _metrics.registry()
        if self._reg is not reg:  # corelint: owned-by=any -- a lookup cache: a racing thread rebinds the same registry's counter
            self._reg, self._counter = reg, reg.counter(self.name)
        self._counter.inc(n)  # corelint: owned-by=any -- the cached counter of the registry just checked


_evicted = _RegistryCounter("tracing.spans-evicted")


class TraceBuffer:
    """Finished root spans and their trees, newest kept, within a budget
    of `max_spans` spans; the spans of each evicted tree are counted in
    `tracing.spans-evicted`.  The newest tree is kept whatever its
    size."""

    def __init__(self, max_spans: int = TRACE_BUFFER_SPANS):
        self.max_spans = max_spans
        self._trees: deque = deque()   # (root, spans in its tree)
        self._spans = 0
        self._lock = make_lock("tracing.buffer")

    def record(self, root: Span) -> None:
        root.export_seq = next(_EXPORT_SEQ)
        n = root.size()
        evicted = 0
        with self._lock:
            self._trees.append((root, n))
            self._spans += n
            while self._spans > self.max_spans and len(self._trees) > 1:
                _, k = self._trees.popleft()
                self._spans -= k
                evicted += k
        if evicted:
            _evicted.inc(evicted)

    def roots(self) -> List[Span]:
        with self._lock:
            return [r for r, _ in self._trees]

    def spans(self) -> int:
        """Spans held, roots and their trees."""
        with self._lock:
            return self._spans

    def clear(self) -> None:
        with self._lock:
            self._trees.clear()
            self._spans = 0


_buffer = TraceBuffer()


def trace_buffer() -> TraceBuffer:
    return _buffer


# ---------------------------------------------------------------------------
# slot-keyed phase marks: the cross-node lifecycle skeleton
# ---------------------------------------------------------------------------

class PhaseMark:
    """One point on a slot's lifecycle: admission-flush, tx-flood,
    nominate, externalize, close-seal, checkpoint-publish.  Cheap (one
    object + two clock reads), node-attributed at record time so an
    in-process multi-node simulation can still split marks per node."""
    __slots__ = ("seq", "phase", "slot", "perf_s", "wall_s", "node",
                 "tid", "args")

    def __init__(self, phase: str, slot: int, node: Optional[str],
                 args: Optional[Dict]):
        self.seq = next(_EXPORT_SEQ)
        self.phase = phase
        self.slot = slot
        self.perf_s = time.perf_counter()
        self.wall_s = wall_now()
        self.node = node
        self.tid = threading.get_ident()
        self.args = args or None

    def to_dict(self) -> dict:
        out = {"seq": self.seq, "phase": self.phase, "slot": self.slot,
               "perf_s": self.perf_s, "wall_s": round(self.wall_s, 6)}
        if self.node is not None:
            out["node"] = self.node
        if self.args:
            out["args"] = jsonable_args(self.args)
        return out


class MarkBuffer:
    """Bounded ring of PhaseMarks (newest kept)."""

    def __init__(self, maxlen: int = MARK_BUFFER_MARKS):
        self._marks: deque = deque(maxlen=maxlen)
        self._lock = make_lock("tracing.marks")

    def record(self, mark: PhaseMark) -> None:
        with self._lock:
            self._marks.append(mark)

    def marks(self) -> List[PhaseMark]:
        with self._lock:
            return list(self._marks)

    def clear(self) -> None:
        with self._lock:
            self._marks.clear()


_marks = MarkBuffer()

_marks_counter = _RegistryCounter("fleet.trace.marks")


def mark_buffer() -> MarkBuffer:
    return _marks


def mark_phase(phase: str, slot: int, node: Optional[str] = None,
               **args) -> PhaseMark:
    """Record a slot-keyed lifecycle mark.  ``node`` defaults to the
    process node id (util/logging.set_node_id); in-process simulations
    pass it explicitly so one process can attribute marks to many
    nodes."""
    if node is None:
        from . import logging as _slog  # lazy: logging imports tracing
        node = _slog.node_id()
    mark = PhaseMark(phase, slot, node, args or None)
    _marks.record(mark)
    _marks_counter.inc()
    return mark


@contextlib.contextmanager
def span(name: str, **args):
    """Open a span under the context-local current span; finished roots
    are recorded in the process trace buffer.  A finished leaf past its
    parent's MAX_CHILD_SPANS leaves, or its tree's MAX_TREE_SPANS, is
    elided (counted in the parent's `truncated`); a span that had
    children of its own never is."""
    parent = _current.get()
    tree = _tree_leaves.get()
    ttoken = None
    if parent is None or tree is None:
        tree = [0]
        ttoken = _tree_leaves.set(tree)
    s = Span(name, args, parent=parent)
    token = _current.set(s)
    try:
        yield s
    finally:
        s.finish()
        _current.reset(token)
        if parent is None:
            _buffer.record(s)
        elif s.children or s.truncated:
            parent.children.append(s)
        elif parent.leaves < MAX_CHILD_SPANS and tree[0] < MAX_TREE_SPANS:
            parent.children.append(s)
            parent.leaves += 1
            tree[0] += 1
        else:
            parent.truncated += 1
        if ttoken is not None:
            _tree_leaves.reset(ttoken)


@contextlib.contextmanager
def timed_span(name: str, cpu: bool = False, **args):
    """span(name, **args) that also updates the registry's timer `name`:
    with the span's seconds, or, with `cpu`, with the seconds of CPU its
    thread spent inside it (time.thread_time), which the span keeps as
    `cpu_s`.  A thread's wall time holds its waits for the GIL; its CPU
    time does not."""
    s = None
    cpu0 = time.thread_time() if cpu else 0.0
    try:
        with span(name, **args) as s:
            try:
                yield s
            finally:
                if cpu:
                    annotate(cpu_s=time.thread_time() - cpu0)
    finally:
        if s is not None:
            _metrics.registry().timer(name).update(
                s.args["cpu_s"] if cpu else s.dur_s)


def current_span() -> Optional[Span]:
    return _current.get()


def jsonable_args(args: Optional[Dict]) -> Optional[Dict]:
    """Span/event key=value fields coerced to JSON-clean scalars (the one
    serialization rule shared by Chrome trace export, span stacks and
    flight-event bundles): scalars pass through, everything else
    stringifies."""
    if not args:
        return None
    return {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else str(v))
            for k, v in args.items()}


def current_span_id() -> Optional[str]:
    """Id of the innermost open span in this thread/context, or None —
    the correlation key structured log records carry."""
    s = _current.get()
    return s.span_id if s is not None else None


def active_span_stack() -> List[dict]:
    """The open span chain of the current context, innermost first —
    what a post-mortem bundle captures as "what was this thread doing".
    Each entry: name, span_id, elapsed_s so far, and the span args."""
    out: List[dict] = []
    s = _current.get()
    now = time.perf_counter()
    while s is not None:
        out.append({"name": s.name, "span_id": s.span_id,
                    "elapsed_s": round(now - s.start_s, 6),
                    "args": jsonable_args(s.args)})
        s = s.parent
    return out


def annotate(**args) -> None:
    """Attach key=value data to the current span (no-op outside one)."""
    s = _current.get()
    if s is not None:
        if s.args is None:
            s.args = {}
        s.args.update(args)


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

def _emit(events: List[dict], s: Span, pid: int,
          pair: Tuple[int, int]) -> None:
    ev = {
        "name": s.name,
        "ph": "X",
        "ts": _wall_ns(s.start_s, pair) / 1e3,
        "dur": round((s.dur_s or 0.0) * 1e6, 3),
        "pid": pid,
        "tid": s.tid,
        "cat": s.name.split(".", 1)[0],
    }
    if s.args:
        # values must be JSON-serializable; coerce the rest to str
        ev["args"] = jsonable_args(s.args)
    if s.truncated:
        ev.setdefault("args", {})["truncated_children"] = s.truncated
    events.append(ev)
    for c in s.children:
        _emit(events, c, pid, pair)


_SLOT_ARG_KEYS = ("slot", "seq", "ledger", "checkpoint")


def _tree_mentions_slot(s: Span, slot: int) -> bool:
    if s.args:
        for k in _SLOT_ARG_KEYS:
            if s.args.get(k) == slot:
                return True
    return any(_tree_mentions_slot(c, slot) for c in s.children)


def to_chrome_trace(roots: Optional[List[Span]] = None,
                    pid: int = 1,
                    slot: Optional[int] = None) -> dict:
    """The trace buffer (or explicit roots) as a Chrome trace-event JSON
    document — load it in chrome://tracing or ui.perfetto.dev.  With
    ``slot``, only root trees mentioning that slot/seq in any span's args
    are emitted (the /trace?slot=N view of one ledger's close)."""
    events: List[dict] = []
    pair = perf_wall_pair()
    for root in (roots if roots is not None else _buffer.roots()):
        if slot is not None and not _tree_mentions_slot(root, slot):
            continue
        _emit(events, root, pid, pair)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def mark_chrome_events(marks: List[PhaseMark], pid: int = 1,
                       wall_offset_s: float = 0.0,
                       anchor: Optional[dict] = None) -> List[dict]:
    """Phase marks as Chrome instant events ("i", thread scope).  When
    ``anchor`` (a clock_anchor() dict from the emitting process) is
    given, each mark's perf timestamp is mapped through it onto the wall
    timebase; otherwise through a fresh perf/wall pair of this process.
    ``wall_offset_s`` shifts the result (fleettrace skew correction)."""
    events: List[dict] = []
    anchor = anchor or clock_anchor()
    for m in marks:
        wall = anchor["wall_s"] + (m.perf_s - anchor["perf_s"])
        ev = {"name": f"{m.phase}@{m.slot}",
              "ph": "i", "s": "t",
              "ts": round((wall + wall_offset_s) * 1e6, 3),
              "pid": pid, "tid": m.tid,
              "cat": "mark",
              "args": {"slot": m.slot, "phase": m.phase}}
        if m.node is not None:
            ev["args"]["node"] = m.node
        if m.args:
            ev["args"].update(jsonable_args(m.args))
        events.append(ev)
    return events


def tracespans_doc(since: int = 0,
                   slot: Optional[int] = None) -> dict:
    """The /tracespans?since=N incremental export: everything recorded
    after watermark ``since`` — phase marks (raw dicts, perf+wall
    stamped) and finished root spans (Chrome events) — plus a FRESH
    clock anchor and the node id, so a cross-node collector can align
    this process onto a shared timebase.  ``next_since`` is the new
    watermark to pass on the next poll.  The spans' timestamps are mapped
    through that anchor, which `epoch` repeats."""
    from . import logging as _slog  # lazy: logging imports tracing
    marks = [m for m in _marks.marks() if m.seq > since
             and (slot is None or m.slot == slot)]
    roots = [r for r in _buffer.roots()
             if r.export_seq is not None and r.export_seq > since]
    span_events: List[dict] = []
    pair = perf_wall_pair()
    for root in roots:
        if slot is not None and not _tree_mentions_slot(root, slot):
            continue
        _emit(span_events, root, 1, pair)
    next_since = max(
        [since] + [m.seq for m in marks]
        + [r.export_seq for r in roots])
    return {"node": _slog.node_id(),
            "anchor": clock_anchor(pair),
            "epoch": clock_anchor(pair),
            "marks": [m.to_dict() for m in marks],
            "spans": span_events,
            "next_since": next_since}


def dump_trace(path: str, roots: Optional[List[Span]] = None) -> int:
    """Write the Chrome trace JSON to `path`; returns the event count."""
    doc = to_chrome_trace(roots)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def spans_between(t0_ns: int, t1_ns: int,
                  name: str) -> List[Tuple[int, int, dict]]:
    """[(start_ns, end_ns, args), ...] of the finished spans called `name`,
    at any depth of the buffer's trees, that overlap [t0_ns, t1_ns] on
    the time_ns clock (util.clock.perf_wall_pair), each clipped to it, in
    order of start."""
    pair = perf_wall_pair()
    out = []
    for root in _buffer.roots():
        stack = [root]
        while stack:
            s = stack.pop()
            stack.extend(s.children)
            if s.name != name:
                continue
            a = _wall_ns(s.start_s, pair)
            lo, hi = max(a, t0_ns), min(a + round(s.dur_s * 1e9), t1_ns)
            if lo < hi:
                out.append((lo, hi, dict(s.args or ())))
    out.sort(key=lambda x: x[0])
    return out


# ---------------------------------------------------------------------------
# the collector's pauses
# ---------------------------------------------------------------------------

GC_PAUSE_TIMER = _metrics.GC_PAUSE_TIMER
GC_FULL_COUNTER = _metrics.GC_FULL_COUNTER
_gc_t0: list = [None]


def _gc_pause(phase: str, info: dict) -> None:
    """gc.callbacks entry: the seconds from a collection's start to its
    stop into the GC_PAUSE_TIMER timer and a pass of generation 2 into
    the GC_FULL_COUNTER counter, both made with each process registry.  It
    takes no lock: a collection may start on a thread that holds any of
    them, the registry's and the timer's own included.  Collections never
    overlap, so nothing else writes here."""
    if phase == "start":
        _gc_t0[0] = time.perf_counter()
        return
    t0, _gc_t0[0] = _gc_t0[0], None
    reg = _metrics.registry()
    timer = reg.lookup(GC_PAUSE_TIMER)
    if t0 is not None and timer is not None:
        timer.update_unlocked(time.perf_counter() - t0)
    full = reg.lookup(GC_FULL_COUNTER)
    if full is not None and info["generation"] == 2:
        full.inc()


def install_gc_pause_timer() -> None:
    """Time every pass of the cyclic collector (once a process)."""
    if _gc_pause not in gc.callbacks:
        gc.callbacks.append(_gc_pause)
