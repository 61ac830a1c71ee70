"""In-process time-series store: the retrospective tier of /metrics.

Reference shape: stellar-core's retained medida history ("what did close
p99 look like over the last hour?") — the live registry (util/metrics)
answers only "what is it now".  A capture tick snapshots the registry
into bounded per-metric rings so a node can answer "when did this start
degrading, and what co-moved with it?" after the fact:

* **Delta encoding**: each ring entry stores only the snapshot fields
  that CHANGED since the previous tick, with a periodic keyframe
  carrying the full field set; readers reconstruct full points by
  replaying deltas from the per-metric base.  Idle metrics cost a few
  bytes per tick instead of a full snapshot row.
* **Tiered retention**: a dense recent window (every tick) plus a
  downsampled tail — points evicted from the dense ring survive at
  1-in-``downsample`` resolution in a second bounded ring, so a
  30-minute-old inflection is still visible after the dense window
  rolled past it.
* **Watermark export**: ``doc(since)`` mirrors tracing.tracespans_doc —
  every capture tick gets a monotonically increasing ``seq`` and the
  document carries ``next_since``, so /timeseries?since= readers (and
  the fleet scraper) pull incrementally without re-shipping history.

Capture is driven two ways, both OUTSIDE detguard regions (this is
observability-plane infrastructure, same exemption as sampleprof):
a VirtualTimer armed by the Application under VIRTUAL_TIME (tests crank
it deterministically), or the ``start()`` wall-cadence daemon thread on
real nodes.  The capture tick re-resolves ``registry()`` every time —
tests swap the whole registry object via reset_registry() and a cached
handle would snapshot a dead registry forever.

``dump()`` persists the full document next to crash bundles
($STPU_CRASH_DIR) and the ``stellar-core-tpu tsdump`` subcommand reads
it back offline.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from .clock import monotonic_now, wall_now
from .lockorder import make_lock
from .metrics import Histogram
from .metrics import registry as _metrics_registry
from .racetrace import race_checked

# Dense window: every capture tick; at the default 1 s cadence this is
# ~8.5 minutes of full-resolution history per metric.
DENSE_POINTS = int(os.environ.get("STPU_TIMESERIES_DENSE", "512"))
# Downsampled tail: 1 in DOWNSAMPLE of the points evicted from the dense
# ring — another ~68 minutes at 1 s cadence, bounded in count.
TAIL_POINTS = int(os.environ.get("STPU_TIMESERIES_TAIL", "512"))
DOWNSAMPLE = 8
# Full-field keyframe cadence inside the delta stream: bounds the replay
# work a read does and makes the stream robust to any base drift.
KEY_INTERVAL = 16

_NUMERIC = (int, float)


def _fields_of(snap: dict) -> Dict[str, float]:
    """The numeric fields of one metric snapshot (type tag dropped;
    dead-gauge None dropped — absence encodes it)."""
    return {k: v for k, v in snap.items()
            if k != "type" and isinstance(v, _NUMERIC) and v == v}


@race_checked
class TimeSeriesStore:
    """Bounded per-metric history of registry snapshots.  Fed by the
    capture tick (clock timer or wall daemon) and drained by
    /timeseries readers, the anomaly detector and dump files — every
    access is under ``_lock``."""

    def __init__(self, cadence_s: float = 1.0,
                 dense_points: int = DENSE_POINTS,
                 tail_points: int = TAIL_POINTS,
                 downsample: int = DOWNSAMPLE,
                 key_interval: int = KEY_INTERVAL) -> None:
        self.cadence_s = cadence_s
        self._dense_points = max(2, dense_points)
        self._tail_points = max(1, tail_points)
        self._downsample = max(1, downsample)
        self._key_interval = max(1, key_interval)
        self._lock = make_lock("timeseries.store")
        # per metric: dense delta ring of (seq, t, delta, is_key), the
        # full-field base as of just-before-the-oldest dense entry, the
        # full fields as of the newest entry (delta source), and the
        # downsampled tail ring of (seq, t, full_fields)
        self._dense: Dict[str, deque] = {}
        self._base: Dict[str, Dict[str, float]] = {}
        self._last: Dict[str, Dict[str, float]] = {}
        self._tail: Dict[str, deque] = {}
        self._seq = 0
        self._reg_box: List[object] = [None]
        # last-seen update count per Timer/Histogram — capture-thread
        # private (never read outside capture()), keyed like _last
        self._hist_counts: Dict[str, int] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -- capture ------------------------------------------------------------
    def capture(self, now: Optional[float] = None) -> int:
        """Snapshot the live registry into the rings; returns the tick's
        seq.  ``now`` lets virtual-time drivers stamp virtual seconds;
        wall-cadence capture stamps monotonic seconds."""
        t0 = monotonic_now()
        reg = _metrics_registry()
        if self._reg_box[0] is not reg:  # corelint: owned-by=timeseries-capture -- capture()-private cache; one capture driver per store (wall daemon OR clock timer), never both
            # registry swapped (reset_registry): re-home the self gauges
            self._reg_box[0] = reg
            self._hist_counts.clear()  # corelint: owned-by=timeseries-capture -- capture()-private cache; single capture driver per store
            reg.weak_gauge("timeseries.points.retained", self,
                           TimeSeriesStore.point_count)
            reg.weak_gauge("timeseries.capture.seq", self,
                           lambda s: s.seq)
        # Change-aware snapshot: a Timer/Histogram's fields derive only
        # from state mutated by update()/reset(), and both move `count`,
        # so an unchanged count means a bit-identical snapshot — skip
        # the percentile recompute (sorting a 1028-sample reservoir) and
        # reuse the last captured fields.  On a fleet-sim registry
        # (51 nodes sharing one process, thousands of timers) this is
        # the difference between ~80ms and ~2ms per tick — the <2%
        # ride-along budget the bench `telemetry` section asserts.
        snapshot: Dict[str, Optional[Dict[str, float]]] = {}
        for name, m in reg.items():
            if isinstance(m, Histogram):
                c = m.count
                if c == self._hist_counts.get(name):
                    snapshot[name] = None    # unchanged: reuse _last
                    continue
                self._hist_counts[name] = c
            snapshot[name] = _fields_of(m.snapshot())
        if now is None:
            now = t0
        with self._lock:
            self._seq += 1
            seq = self._seq
            for name, snap in snapshot.items():
                fields = snap if snap is not None \
                    else self._last.get(name, {})
                dq = self._dense.get(name)
                if dq is None:
                    dq = self._dense[name] = deque()
                    self._tail[name] = deque(maxlen=self._tail_points)
                    self._base[name] = {}
                    self._last[name] = {}
                last = self._last[name]
                is_key = seq % self._key_interval == 0
                if is_key:
                    delta = dict(fields)
                else:
                    delta = {k: v for k, v in fields.items()
                             if last.get(k) != v}
                if len(dq) >= self._dense_points:
                    self._base[name] = self._evict(
                        dq, self._base[name], self._tail[name])
                dq.append((seq, now, delta, is_key))
                self._last[name] = fields
        dur = monotonic_now() - t0
        reg.counter("timeseries.capture.ticks").inc()
        reg.timer("timeseries.capture.tick-time").update(dur)
        return seq

    def _evict(self, dq: deque, base: dict, tail: deque) -> dict:
        """Roll the oldest dense entry into the base (returned for the
        caller — who holds _lock — to store); 1 in downsample of evicted
        points survives as a full point in the tail ring."""
        seq, t, delta, is_key = dq.popleft()
        if is_key:
            base = dict(delta)
        else:
            base = dict(base)
            base.update(delta)
        if seq % self._downsample == 0:
            tail.append((seq, t, base))
        return base

    # -- wall-cadence capture thread (real nodes) ---------------------------
    def start(self, cadence_s: Optional[float] = None) -> None:
        """Start the wall-cadence capture daemon.  Idempotent.  Sims use
        a VirtualTimer driving capture() instead (Application wiring)."""
        if self._thread is not None and self._thread.is_alive():
            return
        if cadence_s is not None:
            self.cadence_s = cadence_s  # corelint: owned-by=main -- set before the daemon starts; daemon/export reads are GIL-atomic float snapshots
        self._stop_evt = threading.Event()  # corelint: owned-by=main -- rebound before thread start; Event is its own synchronizer
        self._thread = threading.Thread(
            target=self._run, name="timeseries-capture", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        evt = self._stop_evt
        while not evt.wait(self.cadence_s):
            try:
                self.capture()
            except Exception:  # corelint: disable=exception-hygiene -- capture must never kill its own daemon; next tick retries
                pass

    def stop(self) -> None:
        """Stop the capture daemon (no-op for timer-driven stores)."""
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=5.0)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def point_count(self) -> int:
        with self._lock:
            return (sum(len(d) for d in self._dense.values())
                    + sum(len(d) for d in self._tail.values()))

    def metric_names(self) -> List[str]:
        with self._lock:
            return sorted(self._dense)

    # -- export -------------------------------------------------------------
    def doc(self, since: int = 0,
            metric: Optional[str] = None) -> dict:
        """The /timeseries document: reconstructed full points with
        ``seq > since``, tail + dense merged per metric, plus the
        ``next_since`` watermark (same contract as tracespans_doc)."""
        series: Dict[str, List[dict]] = {}
        with self._lock:
            names = [metric] if metric else sorted(self._dense)
            for name in names:
                dq = self._dense.get(name)
                if dq is None:
                    continue
                points: List[dict] = []
                for seq, t, fields in self._tail.get(name, ()):
                    if seq > since:
                        points.append({"seq": seq, "t": round(t, 6),
                                       "v": dict(fields)})
                full = dict(self._base.get(name, {}))
                for seq, t, delta, is_key in dq:
                    if is_key:
                        full = dict(delta)
                    else:
                        full.update(delta)
                    if seq > since:
                        points.append({"seq": seq, "t": round(t, 6),
                                       "v": dict(full)})
                if points:
                    series[name] = points
            next_since = max(since, self._seq)
        return {"series": series, "next_since": next_since,
                "cadence_s": self.cadence_s}

    def latest(self, metric: str) -> Optional[dict]:
        """The newest full point for one metric, or None."""
        with self._lock:
            dq = self._dense.get(metric)
            if not dq:
                return None
            seq, t, _, _ = dq[-1]
            return {"seq": seq, "t": round(t, 6),
                    "v": dict(self._last.get(metric, {}))}

    def window(self, metric: str, ticks: int) -> List[dict]:
        """The trailing ``ticks`` full points of one metric — the
        breaching-window slice an anomaly bundle ships."""
        with self._lock:
            floor = self._seq - ticks
        return self.doc(since=max(0, floor),
                        metric=metric)["series"].get(metric, [])

    def bundle(self, ticks: int = 64) -> dict:
        """Flight-bundle source: the trailing window of every series."""
        with self._lock:
            floor = max(0, self._seq - ticks)
        out = self.doc(since=floor)
        out["captures"] = out.pop("next_since")
        return out

    # -- persistence --------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> str:
        """Persist the full document as JSON next to crash bundles
        ($STPU_CRASH_DIR, cwd fallback); returns the path written."""
        doc = self.doc(0)
        doc["kind"] = "timeseries-dump"
        doc["reason"] = reason
        doc["wall_time"] = wall_now()
        if path is None:
            out_dir = os.environ.get("STPU_CRASH_DIR", ".")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(
                out_dir,
                f"timeseries-{os.getpid()}-{doc['next_since']}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def load_dump(path: str) -> dict:
    """Read back a dump() file (the tsdump subcommand's loader);
    raises ValueError on files that are not time-series dumps."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != "timeseries-dump" \
            or not isinstance(doc.get("series"), dict):
        raise ValueError(f"{path}: not a timeseries dump file")
    return doc
