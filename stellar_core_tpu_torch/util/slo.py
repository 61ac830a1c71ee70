"""Declarative SLOs with burn-rate tracking.

Reference shape: SRE burn-rate alerting (error-budget consumption over a
trailing window) applied to the node's own /metrics surface.  A raw
point threshold ("close p99 < 2 s at the end of the soak") converts a
single bad window into a campaign failure and a slowly-degrading node
into a pass; a *burn budget* ("at most 10% of evaluation windows may
breach") is what the fleet and chaos soaks actually mean.

An ``Objective`` names one metric field and a threshold; ``SLOTracker``
evaluates a set of objectives against registry snapshots on a cadence
(the Application's local timer, or util/fleettrace.FleetScraper for the
fleet-wide view), remembers a bounded window of verdicts per objective,
and derives ``burn_rate = breaches / evaluations`` over that window.
Crossing the budget in either direction flips a ``burning`` latch and
records a flight event (util/eventlog) — so the moment an SLO started
burning is in every crash bundle — plus ``slo.burn.flips`` /
``slo.objective.<name>`` metrics for the scraper curves.

The /slo admin endpoint serves ``SLOTracker.report()``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .clock import monotonic_now
from .lockorder import make_lock
from .metrics import registry as _registry

# Evaluations remembered per objective: at the default 1 s fleet scrape
# cadence this is a 2-minute trailing window.
DEFAULT_WINDOW = 120


@dataclass(frozen=True)
class Objective:
    """One service-level objective over a single metric field.

    ``comparison`` is the HEALTHY direction: "<=" means values at or
    under ``threshold`` meet the objective (latencies); ">=" means
    values at or over it do (rates/throughput).  ``budget`` is the
    allowed breach *fraction* of the trailing evaluation window."""
    name: str               # kebab-case; becomes slo.objective.<name>
    metric: str             # registry name, e.g. "ledger.ledger.close"
    field: str              # snapshot field, e.g. "p99_s"
    threshold: float
    comparison: str = "<="  # "<=" or ">="
    budget: float = 0.10
    window: int = DEFAULT_WINDOW

    def met(self, value: float) -> bool:
        if self.comparison == "<=":
            return value <= self.threshold
        if self.comparison == ">=":
            return value >= self.threshold
        raise ValueError(f"unknown comparison {self.comparison!r}")


class _ObjectiveState:
    __slots__ = ("verdicts", "values", "burning", "last_value")

    def __init__(self, window: int):
        # verdicts: deque of (mono_s, breached) — the burn window
        self.verdicts: deque = deque(maxlen=window)
        self.values: deque = deque(maxlen=window)
        self.burning = False
        self.last_value: Optional[float] = None


class SLOTracker:
    """Evaluates objectives against metric snapshots and tracks per-
    objective burn rates.  Thread-safe: the fleet scraper thread and an
    admin /slo read may interleave."""

    def __init__(self, objectives: List[Objective],
                 source: str = "local"):
        self.objectives = list(objectives)
        self.source = source
        self._states: Dict[str, _ObjectiveState] = {
            o.name: _ObjectiveState(o.window) for o in self.objectives}
        self._lock = make_lock("slo.tracker")
        # optional leading indicator: a zero-arg callable returning the
        # currently-active anomaly series names (util/anomaly) — anomalies
        # flag departures from the node's OWN baseline, usually before an
        # absolute SLO threshold is crossed
        self._anomaly_source = None
        reg = _registry()
        reg.counter("slo.eval.windows")
        reg.counter("slo.burn.flips")
        for o in self.objectives:
            # weak source: a torn-down tracker reads as null, never pins
            reg.weak_gauge(f"slo.objective.{o.name}", self,
                           _burn_gauge_source(o.name))

    def attach_anomaly_source(self, fn) -> None:
        """Wire an anomaly reader (e.g. AnomalyDetector.active) as a
        leading indicator: report() surfaces the active series so a /slo
        read shows WHY budget is about to burn, not just that it did."""
        with self._lock:
            self._anomaly_source = fn

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, snapshot: Optional[Dict[str, dict]] = None,
                 now: Optional[float] = None) -> dict:
        """Evaluate every objective against ``snapshot`` (defaulting to
        the process registry).  An objective whose metric/field is
        absent or None is SKIPPED (no verdict recorded) — a node that
        never did catchup must not count as breaching a catchup SLO.
        Returns {objective: burning} for the objectives evaluated."""
        if snapshot is None:
            snapshot = _registry().snapshot()
        if now is None:
            now = monotonic_now()
        _registry().counter("slo.eval.windows").inc()
        flips: List[tuple] = []
        out: Dict[str, bool] = {}
        with self._lock:
            for o in self.objectives:
                snap = snapshot.get(o.metric)
                if snap is None:
                    continue
                value = snap.get(o.field)
                if value is None:
                    continue
                st = self._states[o.name]
                breached = not o.met(float(value))
                st.verdicts.append((now, breached))
                st.values.append((now, float(value)))
                st.last_value = float(value)
                rate = self._burn_rate_locked(o.name)
                burning = rate > o.budget
                if burning != st.burning:
                    st.burning = burning
                    flips.append((o, rate, burning))
                out[o.name] = burning
        # flight events OUTSIDE the tracker lock: record() takes the
        # eventlog leaf lock and we must not nest ours above it
        for o, rate, burning in flips:
            _registry().counter("slo.burn.flips").inc()
            from . import eventlog
            eventlog.record(
                "Perf", "WARNING" if burning else "INFO",
                "slo burn started" if burning else "slo burn cleared",
                objective=o.name, burn_rate=round(rate, 4),
                budget=o.budget, threshold=o.threshold,
                source=self.source)
        return out

    def _burn_rate_locked(self, name: str) -> float:
        st = self._states[name]
        if not st.verdicts:
            return 0.0
        breaches = sum(1 for _, b in st.verdicts if b)
        return breaches / len(st.verdicts)

    # -- readers ------------------------------------------------------------
    def burn_rate(self, name: str) -> float:
        with self._lock:
            return self._burn_rate_locked(name)

    def burning(self, name: str) -> bool:
        with self._lock:
            return self._states[name].burning

    def within_budget(self) -> bool:
        """True when NO objective currently burns its budget — what a
        soak asserts instead of raw end-of-run point thresholds."""
        with self._lock:
            return not any(st.burning for st in self._states.values())

    def report(self) -> dict:
        """The /slo document: per-objective verdict history summary and
        value curve (bounded by the objective window)."""
        objectives = {}
        with self._lock:
            for o in self.objectives:
                st = self._states[o.name]
                breaches = sum(1 for _, b in st.verdicts if b)
                objectives[o.name] = {
                    "metric": o.metric, "field": o.field,
                    "threshold": o.threshold,
                    "comparison": o.comparison,
                    "budget": o.budget,
                    "evaluations": len(st.verdicts),
                    "breaches": breaches,
                    "burn_rate": round(
                        breaches / len(st.verdicts), 4)
                    if st.verdicts else 0.0,
                    "burning": st.burning,
                    "last_value": st.last_value,
                    "curve": [[round(t, 3), v]
                              for t, v in st.values],
                }
            ok = not any(st.burning for st in self._states.values())
            anomaly_source = self._anomaly_source
        doc = {"source": self.source, "ok": ok,
               "objectives": objectives}
        if anomaly_source is not None:
            # read OUTSIDE our lock: the detector takes its own lock and
            # must stay a leaf relative to slo.tracker
            try:
                doc["anomalies"] = list(anomaly_source())
            except Exception:  # corelint: disable=exception-hygiene -- a torn-down detector must not break /slo
                doc["anomalies"] = []
        return doc


def _burn_gauge_source(name: str):
    def read(tracker: "SLOTracker") -> float:
        return tracker.burn_rate(name)  # raises on None → gauge null
    return read


def default_objectives(close_p99_s: float = 2.0,
                       admission_p99_s: float = 0.5,
                       catchup_rate: float = 20.0,
                       budget: float = 0.10,
                       window: int = DEFAULT_WINDOW) -> List[Objective]:
    """The node's standing objectives: close latency, admission intake
    latency, and catchup throughput (evaluated only while the metrics
    exist — an in-sync node records no catchup rate)."""
    return [
        Objective("close-p99", "ledger.ledger.close", "p99_s",
                  close_p99_s, "<=", budget, window),
        Objective("admission-p99", "herder.admission.latency", "p99_s",
                  admission_p99_s, "<=", budget, window),
        Objective("catchup-rate", "catchup.parallel.range-rate", "p50",
                  catchup_rate, ">=", budget, window),
    ]
