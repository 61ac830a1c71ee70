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
  safe — each thread traces its own tree.
- finished ROOT spans land in a bounded ring buffer (newest wins); child
  spans attach to their parent and cost two perf_counter calls + one
  object.
- `to_chrome_trace()` renders the buffer as Chrome trace-event JSON
  (`{"traceEvents": [...]}`, "X" complete events, microsecond units);
  `dump_trace(path)` writes it to a file; the `/trace` admin endpoint
  serves it over HTTP.

Tracing is always on: the buffer is bounded in ALL dimensions —
TRACE_BUFFER_SPANS roots, MAX_CHILD_SPANS children per span, and
MAX_TREE_SPANS total spans per root tree (the elided tail is counted in
each span's `truncated_children` arg) — and span overhead is far below
the operations instrumented (ledger close, checkpoint download, bucket
merge).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .clock import wall_now
from .lockorder import make_lock

TRACE_BUFFER_SPANS = 64
# Per-parent child cap: a replay crank can hold thousands of tx.apply
# leaves per ledger; beyond this the tail is elided (the span records how
# many were dropped).  256 leaves is more than chrome://tracing is
# readable at anyway.
MAX_CHILD_SPANS = 256
# Total-span budget per root tree: the per-parent cap alone is
# multiplicative (64 ledgers x 256 leaves each), so a whole tree is also
# budgeted — once exhausted, further spans are elided and counted in
# their parent's truncated tally.  Worst case the ring then pins
# TRACE_BUFFER_SPANS * MAX_TREE_SPANS spans (~a few MB), a real bound.
MAX_TREE_SPANS = 2048

_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("stpu_current_span", default=None)
# span count of the current root tree ([n] so children mutate in place)
_tree_count: contextvars.ContextVar[Optional[list]] = \
    contextvars.ContextVar("stpu_tree_count", default=None)

# one wall-clock anchor so ts values in an export share an epoch
_EPOCH_WALL = wall_now()
_EPOCH_PERF = time.perf_counter()

# shared export sequence over phase marks AND finished root spans: an
# incremental consumer (/tracespans?since=) names one watermark and gets
# exactly the new data of both kinds (GIL-atomic counter)
_EXPORT_SEQ = itertools.count(1)

# Phase-mark ring capacity: a 5-node soak emits ~6 marks/slot/node; 4096
# covers hundreds of slots between collector scrapes.
MARK_BUFFER_MARKS = 4096


def clock_anchor() -> dict:
    """A fresh monotonic↔wall pairing for this process: perf_counter and
    wall clock sampled back-to-back.  A cross-node collector uses the
    pair to map each node's perf-epoch timestamps onto one wall timebase
    (util/fleettrace aligns residual wall skew via matched slot marks)."""
    return {"perf_s": time.perf_counter(), "wall_s": wall_now()}

# process-unique span ids (GIL-atomic counter).  The id is what a
# structured log line carries (util/logging LOG_FORMAT=json) so a slow
# span can be joined against every record it emitted.
_SPAN_IDS = itertools.count(1)


class Span:
    __slots__ = ("name", "start_s", "dur_s", "args", "children", "tid",
                 "truncated", "span_id", "parent", "export_seq")

    def __init__(self, name: str, args: Optional[Dict] = None,
                 parent: Optional["Span"] = None):
        self.name = name
        self.start_s = time.perf_counter()
        self.dur_s: Optional[float] = None
        self.args = args or None
        self.children: List["Span"] = []
        self.tid = threading.get_ident()
        self.truncated = 0  # children elided past MAX_CHILD_SPANS
        self.span_id = f"{next(_SPAN_IDS):x}"
        self.parent = parent
        self.export_seq: Optional[int] = None  # set when a root is recorded

    def finish(self) -> None:
        self.dur_s = time.perf_counter() - self.start_s

    def depth(self) -> int:
        """Nesting levels including self (a leaf is 1)."""
        return 1 + max((c.depth() for c in self.children), default=0)

    def to_dict(self) -> dict:
        return {"name": self.name, "start_s": self.start_s,
                "dur_s": self.dur_s, "args": self.args,
                "children": [c.to_dict() for c in self.children]}


class TraceBuffer:
    """Bounded ring of finished root spans (newest kept)."""

    def __init__(self, maxlen: int = TRACE_BUFFER_SPANS):
        self._roots: deque = deque(maxlen=maxlen)
        self._lock = make_lock("tracing.buffer")

    def record(self, root: Span) -> None:
        root.export_seq = next(_EXPORT_SEQ)
        with self._lock:
            self._roots.append(root)

    def roots(self) -> List[Span]:
        with self._lock:
            return list(self._roots)

    def clear(self) -> None:
        with self._lock:
            self._roots.clear()


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

# counter cached per registry INSTANCE (same pattern as eventlog.record):
# reset_registry() in tests swaps the registry, so the identity check
# re-resolves the cached counter at one `is` per mark
_mark_counter_box: list = [None, None]


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
    from .metrics import registry as _registry
    reg = _registry()
    if _mark_counter_box[0] is not reg:
        _mark_counter_box[0] = reg
        _mark_counter_box[1] = reg.counter("fleet.trace.marks")
    _mark_counter_box[1].inc()
    return mark


@contextlib.contextmanager
def span(name: str, **args):
    """Open a span under the context-local current span; finished roots
    are recorded in the process trace buffer."""
    parent = _current.get()
    counter = _tree_count.get()
    ctoken = None
    if parent is None or counter is None:
        counter = [1]
        ctoken = _tree_count.set(counter)
    else:
        counter[0] += 1
    s = Span(name, args, parent=parent)
    token = _current.set(s)
    try:
        yield s
    finally:
        s.finish()
        _current.reset(token)
        if parent is not None:
            if len(parent.children) < MAX_CHILD_SPANS \
                    and counter[0] <= MAX_TREE_SPANS:
                parent.children.append(s)
            else:
                parent.truncated += 1
        else:
            _buffer.record(s)
        if ctoken is not None:
            _tree_count.reset(ctoken)


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

def _emit(events: List[dict], s: Span, pid: int) -> None:
    ts_us = (_EPOCH_WALL + (s.start_s - _EPOCH_PERF)) * 1e6
    ev = {
        "name": s.name,
        "ph": "X",
        "ts": round(ts_us, 3),
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
        _emit(events, c, pid)


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
    for root in (roots if roots is not None else _buffer.roots()):
        if slot is not None and not _tree_mentions_slot(root, slot):
            continue
        _emit(events, root, pid)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def mark_chrome_events(marks: List[PhaseMark], pid: int = 1,
                       wall_offset_s: float = 0.0,
                       anchor: Optional[dict] = None) -> List[dict]:
    """Phase marks as Chrome instant events ("i", thread scope).  When
    ``anchor`` (a clock_anchor() dict from the emitting process) is
    given, each mark's perf timestamp is mapped through it onto the wall
    timebase; otherwise the process-local epoch applies.
    ``wall_offset_s`` shifts the result (fleettrace skew correction)."""
    events: List[dict] = []
    for m in marks:
        if anchor is not None:
            wall = anchor["wall_s"] + (m.perf_s - anchor["perf_s"])
        else:
            wall = _EPOCH_WALL + (m.perf_s - _EPOCH_PERF)
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
    watermark to pass on the next poll."""
    from . import logging as _slog  # lazy: logging imports tracing
    marks = [m for m in _marks.marks() if m.seq > since
             and (slot is None or m.slot == slot)]
    roots = [r for r in _buffer.roots()
             if r.export_seq is not None and r.export_seq > since]
    span_events: List[dict] = []
    for root in roots:
        if slot is not None and not _tree_mentions_slot(root, slot):
            continue
        _emit(span_events, root, pid=1)
    next_since = max(
        [since] + [m.seq for m in marks]
        + [r.export_seq for r in roots])
    return {"node": _slog.node_id(),
            "anchor": clock_anchor(),
            "epoch": {"wall_s": _EPOCH_WALL, "perf_s": _EPOCH_PERF},
            "marks": [m.to_dict() for m in marks],
            "spans": span_events,
            "next_since": next_since}


def dump_trace(path: str, roots: Optional[List[Span]] = None) -> int:
    """Write the Chrome trace JSON to `path`; returns the event count."""
    doc = to_chrome_trace(roots)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
