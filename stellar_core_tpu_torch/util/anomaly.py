"""Adaptive anomaly baselines: EWMA mean + MAD band regression alerts.

Fixed SLO thresholds (util/slo) catch "worse than the contract"; this
module catches "worse than *yourself*" — the leading indicator.  Each
tracked series keeps an exponentially-weighted mean and an
exponentially-weighted mean absolute deviation (a robust stand-in for
the MAD proper that needs no sample window); the healthy band is
``mean ± k·max(ewmad, floor)``.  A value outside the band on the bad
side is a *breach*; ``breach_n`` consecutive breaches flip the series
ACTIVE (sustained departure, not a one-tick spike), ``clear_n``
consecutive in-band evaluations flip it back.  The baseline only adapts
on in-band samples once warmed up — otherwise a sustained regression
drags its own baseline along and self-clears without recovering.

On detection the detector records an ``anomaly-detected`` flight event,
bumps ``anomaly.active.<series>`` (weak gauges; ``anomaly.active`` is
the total), and writes an **anomaly bundle**: the breaching time-series
window (util/timeseries), the surrounding CloseCostRecords
(ledger/costs) and the sampling profiler's folded stacks — the
post-mortem a human would have assembled by hand, written at the moment
the regression is still live.  ``anomaly-cleared`` closes the episode.

Two feeding modes share the state machine: ``evaluate()`` pulls the
live registry on the Application's timer (outside detguard regions,
observability-plane exemption), and ``observe()`` pushes explicit
values — how FleetScraper runs one detector per scraped node.
SLOTracker consumes ``active()`` as its leading indicator.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .clock import monotonic_now, wall_now
from .lockorder import make_lock
from .metrics import registry as _registry
from .racetrace import race_checked

# Bundles written per ACTIVE episode (one at detection, not per eval)
BUNDLE_TS_WINDOW = 64        # breaching time-series ticks shipped
BUNDLE_COST_ROWS = 64        # surrounding CloseCostRecords shipped


@dataclass(frozen=True)
class TrackedSeries:
    """One adaptively-baselined series.

    ``direction`` is the BAD side: "high" flags upward departures
    (latencies, stall times), "low" flags downward ones (hit rates,
    throughput).  ``floor`` is a minimum band half-width in the value's
    own units so a near-constant warm-up (MAD ~ 0) doesn't make every
    later wiggle an anomaly."""
    name: str                 # kebab-case; becomes anomaly.active.<name>
    metric: str               # registry name, e.g. "ledger.ledger.close"
    field: str                # snapshot field, e.g. "p99_s"
    direction: str = "high"   # "high" | "low"
    k: float = 5.0            # band half-width in EWMA-MADs
    floor: float = 0.0        # minimum band half-width (value units)
    min_samples: int = 8      # baseline warm-up before any flagging
    breach_n: int = 3         # consecutive breaches to flag
    clear_n: int = 3          # consecutive in-band evals to clear


class _SeriesState:
    __slots__ = ("n", "mean", "ewmad", "breaches", "clears", "active",
                 "last_value", "last_band", "episodes")

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.ewmad = 0.0
        self.breaches = 0
        self.clears = 0
        self.active = False
        self.last_value: Optional[float] = None
        self.last_band: Optional[float] = None
        self.episodes = 0


@race_checked
class AnomalyDetector:
    """Per-series EWMA/MAD state machine.  Thread-safe: the evaluation
    timer, FleetScraper sweeps and admin /metrics gauge reads may
    interleave — every state access is under ``_lock``; flight events
    and bundle writes happen OUTSIDE it (eventlog's lock is a leaf)."""

    def __init__(self, tracked: List[TrackedSeries],
                 alpha: float = 0.2,
                 timeseries: Optional[Callable[[], object]] = None,
                 closecosts: Optional[Callable[[], object]] = None,
                 source: str = "local",
                 register_gauges: bool = True) -> None:
        self.tracked = list(tracked)
        self.alpha = alpha
        self.source = source
        # zero-arg providers so the detector never pins the app graph
        # (Application wires weakref-backed lambdas)
        self._timeseries = timeseries
        self._closecosts = closecosts
        self._lock = make_lock("anomaly.detector")
        self._states: Dict[str, _SeriesState] = {
            t.name: _SeriesState() for t in self.tracked}
        self._by_name: Dict[str, TrackedSeries] = {
            t.name: t for t in self.tracked}
        # cache.hit/.miss lifetime counts from the previous evaluation —
        # the derived hit-rate series is computed over per-eval deltas
        self._cache_prev: Optional[tuple] = None
        self._bundle_n = 0
        if register_gauges:
            reg = _registry()
            reg.counter("anomaly.flags")
            reg.counter("anomaly.clears")
            reg.weak_gauge("anomaly.active", self,
                           AnomalyDetector.active_count)
            for t in self.tracked:
                reg.weak_gauge(f"anomaly.active.{t.name}", self,
                               _active_gauge_source(t.name))

    # -- state machine ------------------------------------------------------
    def _observe_locked(self, t: TrackedSeries, st: _SeriesState,
                        value: float) -> Optional[bool]:
        """Returns True/False when the ACTIVE latch flips, else None."""
        st.last_value = value
        if st.n < t.min_samples:
            # warm-up: adapt unconditionally, never flag
            self._adapt_locked(st, value)
            st.n += 1
            st.last_band = t.k * max(st.ewmad, t.floor)
            return None
        band = t.k * max(st.ewmad, t.floor)
        st.last_band = band
        if t.direction == "high":
            breached = value > st.mean + band
        else:
            breached = value < st.mean - band
        flip: Optional[bool] = None
        if breached:
            st.breaches += 1
            st.clears = 0
            if not st.active and st.breaches >= t.breach_n:
                st.active = True
                st.episodes += 1
                flip = True
        else:
            st.clears += 1
            st.breaches = 0
            # adapt only in-band: a sustained regression must not drag
            # its own baseline along and silently self-clear
            self._adapt_locked(st, value)
            st.n += 1
            if st.active and st.clears >= t.clear_n:
                st.active = False
                flip = False
        return flip

    def _adapt_locked(self, st: _SeriesState, value: float) -> None:
        if st.n == 0:
            st.mean = value
            st.ewmad = 0.0
            return
        dev = abs(value - st.mean)
        st.mean += self.alpha * (value - st.mean)
        st.ewmad += self.alpha * (dev - st.ewmad)

    # -- feeding ------------------------------------------------------------
    def observe(self, name: str, value: float) -> bool:
        """Push one sample into a tracked series (FleetScraper mode).
        Returns the series' ACTIVE state after the sample."""
        t = self._by_name[name]
        with self._lock:
            st = self._states[name]
            flip = self._observe_locked(t, st, float(value))
            active = st.active
        if flip is not None:
            self._emit([(t, self._snap_state(name), flip)])
        return active

    def evaluate(self, snapshot: Optional[Dict[str, dict]] = None,
                 now: Optional[float] = None) -> Dict[str, bool]:
        """Pull mode: evaluate every tracked series against a registry
        snapshot (defaulting to the live registry).  Series whose
        metric/field is absent are SKIPPED — a node with no admission
        pipeline must not warm an admission baseline on nulls."""
        if snapshot is None:
            snapshot = _registry().snapshot()
        snapshot = dict(snapshot)
        self._inject_derived(snapshot)
        flips: List[tuple] = []
        out: Dict[str, bool] = {}
        with self._lock:
            for t in self.tracked:
                snap = snapshot.get(t.metric)
                if snap is None:
                    continue
                value = snap.get(t.field)
                if value is None:
                    continue
                st = self._states[t.name]
                flip = self._observe_locked(t, st, float(value))
                if flip is not None:
                    flips.append((t, None, flip))
                out[t.name] = st.active
        if flips:
            self._emit([(t, self._snap_state(t.name), flip)
                        for t, _, flip in flips])
        return out

    def _inject_derived(self, snapshot: Dict[str, dict]) -> None:
        """Synthesize the entry-cache hit-rate series from the hit/miss
        lifetime counters (per-evaluation deltas; no traffic = skip)."""
        hit = snapshot.get("bucketlistdb.cache.hit")
        miss = snapshot.get("bucketlistdb.cache.miss")
        if hit is None or miss is None:
            return
        cur = (hit.get("count", 0), miss.get("count", 0))
        with self._lock:
            prev = self._cache_prev
            self._cache_prev = cur
        if prev is None:
            return
        dh, dm = cur[0] - prev[0], cur[1] - prev[1]
        if dh + dm <= 0 or dh < 0 or dm < 0:
            return
        snapshot["bucketlistdb.cache.hit-rate"] = {
            "type": "gauge", "value": dh / (dh + dm)}

    # -- episode plumbing ---------------------------------------------------
    def _snap_state(self, name: str) -> dict:
        with self._lock:
            st = self._states[name]
            return {"value": st.last_value, "mean": round(st.mean, 6),
                    "band": round(st.last_band or 0.0, 6),
                    "episodes": st.episodes}

    def _emit(self, flips: List[tuple]) -> None:
        """Flight events + bundle writes for latch flips — OUTSIDE the
        detector lock (eventlog's is a leaf; bundle writes do file IO)."""
        from . import eventlog
        reg = _registry()
        for t, state, became_active in flips:
            if became_active:
                reg.counter("anomaly.flags").inc()
                bundle_path = None
                try:
                    bundle_path = self.write_bundle(
                        t.name, reason="anomaly-detected")
                except Exception:  # corelint: disable=exception-hygiene -- a failed dump must not mask the detection event
                    pass
                eventlog.record(
                    "Perf", "WARNING", "anomaly-detected",
                    series=t.name, metric=t.metric, field=t.field,
                    source=self.source, bundle=bundle_path, **state)
            else:
                reg.counter("anomaly.clears").inc()
                eventlog.record(
                    "Perf", "INFO", "anomaly-cleared",
                    series=t.name, metric=t.metric, field=t.field,
                    source=self.source, **state)

    def write_bundle(self, series_name: str,
                     reason: str = "manual",
                     out_dir: Optional[str] = None) -> str:
        """Write the anomaly bundle for one series: breaching
        time-series window + surrounding CloseCostRecords + profiler
        folded stacks.  Returns the path written."""
        t = self._by_name[series_name]
        doc = {"kind": "anomaly-bundle", "series": series_name,
               "metric": t.metric, "field": t.field,
               "reason": reason, "source": self.source,
               "wall_time": wall_now(),
               "state": self._snap_state(series_name)}
        ts = self._timeseries() if self._timeseries else None
        if ts is not None:
            doc["timeseries"] = {
                t.metric: ts.window(t.metric, BUNDLE_TS_WINDOW)}
        cc = self._closecosts() if self._closecosts else None
        if cc is not None:
            doc["closecosts"] = cc.recent(BUNDLE_COST_ROWS)
        from . import sampleprof
        prof = sampleprof.profiler()
        if prof.running():
            doc["profile_folded"] = prof.folded()
        if out_dir is None:
            out_dir = os.environ.get("STPU_CRASH_DIR", ".")
        os.makedirs(out_dir, exist_ok=True)
        with self._lock:
            self._bundle_n += 1
            n = self._bundle_n
        path = os.path.join(
            out_dir, f"anomaly-{series_name}-{os.getpid()}-{n}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    # -- readers ------------------------------------------------------------
    def active(self) -> List[str]:
        """Names of currently-ACTIVE series (SLOTracker's leading
        indicator; sorted for determinism)."""
        with self._lock:
            return sorted(n for n, st in self._states.items()
                          if st.active)

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for st in self._states.values() if st.active)

    def is_active(self, name: str) -> bool:
        with self._lock:
            return self._states[name].active

    def report(self) -> dict:
        """Per-series verdicts (the fleet scraper's per-node doc and the
        'anomaly' flight-bundle source)."""
        series = {}
        with self._lock:
            for t in self.tracked:
                st = self._states[t.name]
                series[t.name] = {
                    "metric": t.metric, "field": t.field,
                    "direction": t.direction,
                    "active": st.active,
                    "episodes": st.episodes,
                    "samples": st.n,
                    "mean": round(st.mean, 6),
                    "band": round(st.last_band or 0.0, 6),
                    "last_value": st.last_value,
                }
        return {"source": self.source, "series": series,
                "active": sorted(n for n, d in series.items()
                                 if d["active"])}


def _active_gauge_source(name: str):
    def read(det: "AnomalyDetector") -> float:
        return 1.0 if det.is_active(name) else 0.0
    return read


def default_tracked() -> List[TrackedSeries]:
    """The node's standing regression watches: close p99, admission
    latency, merge stall, entry-cache hit rate (the four axes ROADMAP
    item 4's read-serving soak degrades first)."""
    return [
        TrackedSeries("close-p99", "ledger.ledger.close", "p99_s",
                      direction="high", floor=0.005),
        TrackedSeries("admission-latency", "herder.admission.latency",
                      "p99_s", direction="high", floor=0.005),
        TrackedSeries("merge-stall", "bucket.merge.stall", "p99_s",
                      direction="high", floor=0.002),
        TrackedSeries("cache-hit-rate", "bucketlistdb.cache.hit-rate",
                      "value", direction="low", floor=0.05),
    ]
