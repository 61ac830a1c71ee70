"""Flight recorder: a bounded ring of structured events + post-mortem
crash bundles.

Reference shape: the reference keeps per-category status lines
(src/main/StatusManager) and an unstructured log stream; when a node
fail-stops, the only artifacts are whatever stderr captured.  This module
answers "what was the node doing in the 30 seconds before it died": a
bounded, lock-ordered ring of structured events (monotonic + wall time,
log partition, severity, key=value fields, current span id) fed by

- explicit ``record()`` calls at lifecycle edges (ledger close seal, SCP
  phase transitions, catchup checkpoint verdicts, bucket merge adopt/GC,
  overlay connect/drop/ban, invariant failures), and
- a logging bridge: every WARNING+ record emitted through the partitioned
  logger (util/logging) lands here automatically.  Records below the
  bridge level cost nothing — stdlib logging filters them before the
  handler runs.

On a fail-stop (LockOrderError, InvariantDoesNotHold, unhandled thread
exception) ``write_crash_bundle()`` dumps ONE JSON bundle — recent flight
events, the active span stack (util/tracing), a full metric snapshot and
any registered bundle sources (herder/SCP state, config fingerprint) —
to ``$STPU_CRASH_DIR``.  The same bundle is served live at the
``/dumpflight`` admin endpoint.

Lock order: the event-log lock is a LEAF — ``record()`` acquires nothing
else while holding it, so it can be called from inside any subsystem's
critical section (including the logging bridge firing under another
lock) without creating new lock-order edges.
"""

from __future__ import annotations

import json
import logging as _pylogging
import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from .clock import monotonic_now, wall_now
from .lockorder import make_lock
from .metrics import registry as _registry
from .racetrace import race_checked
from . import tracing as _tracing

# Ring capacity: a replay close records one event per ledger, live nodes
# far fewer.  Bounded in count, not time.
EVENTLOG_CAPACITY = int(os.environ.get("STPU_EVENTLOG_CAPACITY", "1024"))


class FlightEvent:
    __slots__ = ("mono_s", "wall_s", "partition", "severity", "msg",
                 "fields", "span_id")

    def __init__(self, partition: str, severity: str, msg: str,
                 fields: Optional[Dict], span_id: Optional[str]):
        self.mono_s = monotonic_now()
        self.wall_s = wall_now()
        self.partition = partition
        self.severity = severity
        self.msg = msg
        self.fields = fields
        self.span_id = span_id

    def to_dict(self) -> dict:
        out = {"mono_s": round(self.mono_s, 6),
               "wall_s": round(self.wall_s, 3),
               "partition": self.partition,
               "severity": self.severity,
               "msg": self.msg}
        # node attribution happens at EXPORT time (zero hot-path cost):
        # the record path stays lean and a late
        # set_node_id() still stamps earlier events correctly for the
        # common fleet case (id configured once at startup)
        node = _node_id()
        if node is not None:
            out["node"] = node
        if self.fields:
            out["fields"] = _tracing.jsonable_args(self.fields)
        if self.span_id is not None:
            out["span_id"] = self.span_id
        return out


@race_checked
class EventLog:
    """Bounded ring of FlightEvents (newest kept).  Fed from every
    thread (main crank, admin workers via the log bridge, device worker
    fail paths) and drained by /dumpflight — the canonical race-sanitizer
    subject, which is why every access below is under ``_lock``."""

    def __init__(self, capacity: int = EVENTLOG_CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._lock = make_lock("eventlog.buffer")

    def record(self, partition: str, severity: str, msg: str,
               fields: Optional[Dict] = None) -> FlightEvent:
        ev = FlightEvent(partition, severity, msg, fields or None,
                         _tracing.current_span_id())
        with self._lock:
            self._events.append(ev)
        return ev

    def events(self) -> List[FlightEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def snapshot(self) -> List[dict]:
        return [ev.to_dict() for ev in self.events()]


_log = EventLog()
_partitions: Optional[frozenset] = None


def event_log() -> EventLog:
    """The process-wide flight recorder."""
    return _log


def _known_partitions() -> frozenset:
    # lazy: util/logging attaches the bridge from its _configure(), so a
    # top-level import here would be circular
    global _partitions
    if _partitions is None:
        from .logging import PARTITIONS
        _partitions = frozenset(PARTITIONS)
    return _partitions


def _node_id():
    # same circular-import constraint as _known_partitions
    from .logging import node_id
    return node_id()


# counter cached per registry INSTANCE: reset_registry() (tests) swaps
# the whole registry, so a bare cached counter would go stale — the
# identity check re-resolves it after a swap at one `is` per record
_counter_box: list = [None, None]


def record(partition: str, severity: str, msg: str, **fields) -> None:
    """Record one structured flight event.  ``partition`` must be a
    util/logging partition (corelint's eventlog-partitions rule checks
    literals statically; this is the runtime backstop for dynamic
    callers).  record() sits inside every replay close, so it stays
    cheap."""
    if partition not in _known_partitions():
        raise ValueError(f"unknown log partition {partition!r}")
    reg = _registry()
    if _counter_box[0] is not reg:
        _counter_box[0] = reg
        _counter_box[1] = reg.counter("eventlog.record.count")
    _counter_box[1].inc()
    if not severity.isupper():
        severity = severity.upper()
    _log.record(partition, severity, msg, fields)


# ---------------------------------------------------------------------------
# logging bridge: WARNING+ partitioned-log records land in the recorder
# ---------------------------------------------------------------------------

class FlightRecorderBridge(_pylogging.Handler):
    """Attached to the ``stellar`` root logger (util/logging._configure)
    at WARNING: a record below that level never reaches emit() — the
    zero-cost-when-not-met guarantee is stdlib logging's level check."""

    def __init__(self, level: int = _pylogging.WARNING):
        super().__init__(level)

    def emit(self, rec: _pylogging.LogRecord) -> None:
        try:
            name = rec.name
            partition = name.rsplit(".", 1)[-1] if "." in name else "Main"
            _registry().counter("log.bridge.records").inc()
            _log.record(partition, rec.levelname, rec.getMessage())
        except Exception:  # corelint: disable=exception-hygiene -- a logging handler must never raise into callers
            pass


def bridge_handler() -> FlightRecorderBridge:
    return FlightRecorderBridge()


# ---------------------------------------------------------------------------
# post-mortem bundles
# ---------------------------------------------------------------------------

# name -> zero-arg callable returning a JSON-compatible dict; registered
# by the Application (herder/SCP state, config fingerprint).  A source
# that raises reports its error instead of sinking the whole bundle.
_bundle_sources: Dict[str, Callable[[], dict]] = {}
_bundle_lock = make_lock("eventlog.bundle-sources")
# re-entrancy latch: a fail-stop inside bundle writing (e.g. a metric
# lock inverting while we snapshot) must not recurse forever
_dumping = threading.local()


def register_bundle_source(name: str, fn: Callable[[], dict]) -> None:
    with _bundle_lock:
        _bundle_sources[name] = fn


def unregister_bundle_source(name: str) -> None:
    with _bundle_lock:
        _bundle_sources.pop(name, None)


def flight_bundle(reason: str) -> dict:
    """The post-mortem document: recent flight events, the active span
    stack of the calling thread, a full metric snapshot, and every
    registered bundle source."""
    from . import tracing
    bundle = {
        "reason": reason,
        "node": _node_id(),
        "wall_s": round(wall_now(), 3),
        "mono_s": round(monotonic_now(), 6),
        "thread": threading.current_thread().name,
        "events": _log.snapshot(),
        "span_stack": tracing.active_span_stack(),
        "metrics": _registry().snapshot(),
    }
    with _bundle_lock:
        sources = dict(_bundle_sources)
    for name, fn in sources.items():
        try:
            bundle[name] = fn()
        except Exception as e:  # corelint: disable=exception-hygiene -- a dead source reports its error, never sinks the bundle
            bundle[name] = {"error": str(e)}
    return bundle


def write_crash_bundle(reason: str,
                       crash_dir: Optional[str] = None) -> Optional[str]:
    """Write the flight bundle to ``crash_dir`` (defaulting to
    ``$STPU_CRASH_DIR``; one JSON file per incident); returns the path, or
    None when no directory is configured or the write fails — a crash dump
    must never mask the original fail-stop.  The explicit parameter lets
    in-process harnesses (the chaos campaign runner) route bundles into a
    per-campaign artifact directory without mutating process environment."""
    if getattr(_dumping, "active", False):
        return None
    if crash_dir is None:
        crash_dir = os.environ.get("STPU_CRASH_DIR")
    if not crash_dir:
        return None
    _dumping.active = True
    try:
        bundle = flight_bundle(reason)
        os.makedirs(crash_dir, exist_ok=True)
        path = os.path.join(
            crash_dir,
            f"flight-{int(wall_now() * 1000)}-{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        return path
    except Exception as e:  # corelint: disable=exception-hygiene -- dump failure must not mask the fail-stop being reported
        try:
            from . import logging as slog
            slog.get("Main").error("crash bundle write failed: %s", e)
        except Exception:  # corelint: disable=exception-hygiene -- last-resort: nothing left to report to
            pass
        return None
    finally:
        _dumping.active = False


_prev_threading_excepthook = None


def install_thread_excepthook() -> None:
    """Route unhandled thread exceptions through a crash bundle before
    the default report (reference shape: printErrorAndAbort).  Idempotent."""
    global _prev_threading_excepthook
    if _prev_threading_excepthook is not None:
        return
    prev = threading.excepthook
    _prev_threading_excepthook = prev

    def hook(args) -> None:
        try:
            record("Process", "ERROR",
                   "unhandled exception in thread",
                   thread=args.thread.name if args.thread else "?",
                   exc_type=getattr(args.exc_type, "__name__",
                                    str(args.exc_type)),
                   exc=str(args.exc_value))
            write_crash_bundle(
                f"unhandled thread exception: "
                f"{getattr(args.exc_type, '__name__', args.exc_type)}: "
                f"{args.exc_value}")
        except Exception:  # corelint: disable=exception-hygiene -- excepthook must always reach the default reporter
            pass
        prev(args)

    threading.excepthook = hook
