"""Partitioned logging. Reference: src/util/Logging.{h,cpp} — CLOG_* macros
with per-partition runtime-settable levels (Fs, SCP, Bucket, Overlay, History,
Ledger, Herder, Tx, Database, Process, Work, Invariant, Perf), plus the
spdlog-backed structured mode: ``LOG_FORMAT=json`` (config, or live via
``/ll?format=json``) switches every handler to one-JSON-object-per-line
records that carry the current span id from util/tracing — so a slow
``ledger.close`` span can be joined against every log line it emitted.

Every WARNING+ record is also bridged into the flight recorder
(util/eventlog) for post-mortem bundles; records below the bridge level
never reach the handler (stdlib level filtering — zero cost).
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Dict

PARTITIONS = (
    "Fs", "SCP", "Bucket", "Overlay", "History", "Ledger", "Herder", "Tx",
    "Database", "Process", "Work", "Invariant", "Perf", "Main",
    "CommandHandler", "Fuzz", "Sim",
)

LOG_FORMATS = ("text", "json")

_loggers: Dict[str, logging.Logger] = {}
_configured = False
_format = "text"
# fleet-wide attribution: the node name this process (or in-sim node)
# runs as.  Provisioned per node by simulation/fleet (NODE_NAME config
# key) and stamped into JSON log records, flight-event exports and
# rate-limit keys so aggregated soak logs stay attributable.
_node_id: str | None = None


def set_node_id(name: str | None) -> None:
    """Configure the node name stamped into structured output (JSON log
    records, flight-event exports, /tracespans documents).  None clears."""
    global _node_id
    _node_id = name or None


def node_id() -> str | None:
    """The configured node name, or None when unset (single-node runs)."""
    return _node_id

_TEXT_FORMATTER = logging.Formatter(
    "%(asctime)s [%(name)s %(levelname)s] %(message)s")


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts (epoch seconds), partition, level,
    msg — and the id of the span open in the emitting context, the
    correlation key against /trace exports and flight events."""

    def format(self, rec: logging.LogRecord) -> str:
        from . import tracing
        name = rec.name
        doc = {
            "ts": round(rec.created, 3),
            "partition": name.rsplit(".", 1)[-1] if "." in name else "root",
            "level": rec.levelname,
            "msg": rec.getMessage(),
        }
        if _node_id is not None:
            doc["node"] = _node_id
        span_id = tracing.current_span_id()
        if span_id is not None:
            doc["span"] = span_id
        if rec.exc_info:
            doc["exc"] = self.formatException(rec.exc_info)
        return json.dumps(doc)


_JSON_FORMATTER = JsonFormatter()


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_JSON_FORMATTER if _format == "json"
                         else _TEXT_FORMATTER)
    root = logging.getLogger("stellar")
    root.addHandler(handler)
    # flight-recorder bridge: WARNING+ records become flight events
    # (lazy import — eventlog imports PARTITIONS from this module)
    from . import eventlog
    root.addHandler(eventlog.bridge_handler())
    root.setLevel(logging.INFO)
    _configured = True


def get(partition: str) -> logging.Logger:
    if partition not in PARTITIONS:
        raise ValueError(f"unknown log partition {partition!r}")
    _configure()
    if partition not in _loggers:
        _loggers[partition] = logging.getLogger(f"stellar.{partition}")
    return _loggers[partition]


def set_level(level: str, partition: str | None = None) -> None:
    """Runtime level control (reference: /ll?level=&partition= endpoint)."""
    _configure()
    lvl = getattr(logging, level.upper())
    if partition is None:
        logging.getLogger("stellar").setLevel(lvl)
    else:
        get(partition).setLevel(lvl)


def set_format(fmt: str) -> None:
    """Switch structured output on ("json") or off ("text") at runtime
    (reference semantics: the spdlog pattern swap behind /ll).  Applies to
    every current stream/file handler of the stellar root."""
    global _format
    if fmt not in LOG_FORMATS:
        raise ValueError(f"unknown log format {fmt!r} (expected one of "
                         f"{LOG_FORMATS})")
    _configure()
    _format = fmt
    formatter = _JSON_FORMATTER if fmt == "json" else _TEXT_FORMATTER
    for h in logging.getLogger("stellar").handlers:
        if isinstance(h, logging.StreamHandler):
            h.setFormatter(formatter)


def current_format() -> str:
    return _format


def current_levels() -> dict:
    """Effective level per partition (reference: /ll with no args)."""
    _configure()
    out = {"(root)": logging.getLevelName(
        logging.getLogger("stellar").getEffectiveLevel())}
    for p in PARTITIONS:
        out[p] = logging.getLevelName(get(p).getEffectiveLevel())
    return out


def rotate() -> None:
    """Close+reopen file handlers (reference: /logrotate).  Stream handlers
    have nothing to rotate; file handlers re-open their path so an external
    rotator can move the old file first."""
    _configure()
    for h in logging.getLogger("stellar").handlers:
        if isinstance(h, logging.FileHandler):
            h.close()
            h.stream = h._open()


# ---------------------------------------------------------------------------
# rate limiting: first + every-Nth at the loud level, the rest quiet
# ---------------------------------------------------------------------------

_rate_counts: Dict[str, int] = {}


def rate_limited(log: logging.Logger, key: str, every_n: int):
    """Pick the emit function for one occurrence of a repeating warning:
    the FIRST occurrence and every ``every_n``-th emit at WARNING, the
    rest at DEBUG — the interesting signal is the first hit plus the
    trend, which a counter metric carries exactly either way.  Returns
    ``(emit, occurrence)`` where ``emit`` is ``log.warning`` or
    ``log.debug`` and ``occurrence`` the 1-based count for ``key``.

    Replaces hand-rolled every-Nth counters at call sites (the catchup
    preverify collect-fallback warning was the first).  Keys are scoped
    by the configured node id so in-process multi-node simulations don't
    share one occurrence counter across nodes."""
    if _node_id is not None:
        key = f"{_node_id}:{key}"
    n = _rate_counts.get(key, 0) + 1
    _rate_counts[key] = n
    emit = log.warning if n == 1 or n % every_n == 0 else log.debug
    return emit, n


def discard_rate_limit(key: str) -> None:
    """Drop one key's counter — call when the subsystem that owned the
    key is torn down, so per-instance keys don't accumulate for process
    lifetime."""
    if _node_id is not None:
        key = f"{_node_id}:{key}"
    _rate_counts.pop(key, None)


def reset_rate_limits() -> None:
    """Test seam: forget all rate-limit counters."""
    _rate_counts.clear()
