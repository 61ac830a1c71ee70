"""Fleet-wide observability: cross-node trace collection/merging and a
central metrics scraper.

The per-process planes (util/tracing spans + phase marks, util/metrics
snapshots) see ONE node.  A fleet soak (simulation/fleet — N real
processes over TCP) or a chaos campaign needs the cross-node picture:
did node-3's close seal lag the quorum's externalize, did the rejoining
node's catchup overlap the others' closes, did close p99 degrade slowly
or collapse at the kill.  Two collectors provide it:

``FleetTraceCollector``
    Polls every node's ``/tracespans?since=`` incremental export,
    accumulates marks + span events per node, aligns the nodes onto one
    timebase (each node's monotonic clock is mapped through its
    reported clock anchor; residual wall-clock skew between nodes is
    corrected by matching slot-keyed ``externalize`` marks — the same
    slot externalizes within ms across a healthy quorum, so the median
    per-slot delta IS the skew), and merges everything into ONE Chrome
    trace: one process row per node, phase marks as instant events,
    slot-spanning flow arrows.  ``Fleet.finalize()`` and ChaosRunner
    write the merged file next to their reports.

``FleetScraper``
    A daemon thread polling every node's ``/metrics`` snapshot on a
    cadence into a bounded ring of timestamped snapshots per node —
    fleet SLOs become *curves* (close p99 over time, admission depth,
    shed rate) instead of end-of-run points, with per-node divergence
    deltas; each sweep optionally feeds a util/slo.SLOTracker so burn
    rates are evaluated fleet-wide (every node's window counts).

The copy of stellar_core_tpu/util/fleettrace.py.
"""

from __future__ import annotations

import json
import statistics
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from .clock import monotonic_now
from .lockorder import make_lock
from .metrics import registry as _registry

# Default scrape ring: 600 snapshots/node at the 1 s default cadence =
# a 10-minute window, each snapshot a few KB — bounded by count.
SCRAPE_RING = 600
SCRAPE_CADENCE_S = 1.0

# The phase used for inter-node skew estimation: externalize is the one
# mark every in-sync node emits for every slot within ms of the quorum.
ALIGN_PHASE = "externalize"


def _mark_wall(mark: dict, anchor: Optional[dict]) -> float:
    """A mark's timestamp on the node's anchor-mapped wall timebase.
    The anchor (one monotonic↔wall pairing per node) is authoritative:
    per-event wall stamps would smear NTP steps across the trace."""
    if anchor and "perf_s" in mark:
        return anchor["wall_s"] + (mark["perf_s"] - anchor["perf_s"])
    return mark.get("wall_s", 0.0)


class FleetTraceCollector:
    """Accumulates /tracespans documents per node and merges them into
    one aligned Chrome trace."""

    def __init__(self):
        self._since: Dict[str, int] = {}
        self._marks: Dict[str, List[dict]] = {}
        self._spans: Dict[str, List[dict]] = {}
        self._anchors: Dict[str, dict] = {}
        self._lock = make_lock("fleettrace.collector")

    # -- collection ---------------------------------------------------------
    def since(self, node: str) -> int:
        with self._lock:
            return self._since.get(node, 0)

    def ingest(self, node: str, doc: dict) -> int:
        """Fold one /tracespans response in; returns the number of new
        marks+spans.  ``node`` is the collector-side name — it wins over
        the document's self-reported id (a node misconfigured with a
        duplicate name must not silently merge rows)."""
        marks = doc.get("marks") or []
        spans = doc.get("spans") or []
        with self._lock:
            self._marks.setdefault(node, []).extend(marks)
            self._spans.setdefault(node, []).extend(spans)
            if doc.get("anchor"):
                self._anchors[node] = doc["anchor"]
            nxt = doc.get("next_since")
            if isinstance(nxt, int):
                self._since[node] = max(
                    self._since.get(node, 0), nxt)
        return len(marks) + len(spans)

    def poll(self, node: str,
             fetch: Callable[[str], dict]) -> int:
        """One incremental scrape of ``node`` via ``fetch(path)`` (e.g.
        FleetNode.http_json); raises whatever fetch raises."""
        doc = fetch(f"/tracespans?since={self.since(node)}")
        return self.ingest(node, doc)

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(set(self._marks) | set(self._spans))

    def marks(self, node: str) -> List[dict]:
        with self._lock:
            return list(self._marks.get(node, []))

    # -- alignment ----------------------------------------------------------
    def align_offsets(self, phase: str = ALIGN_PHASE) -> Dict[str, float]:
        """Per-node wall-clock offsets (seconds to ADD to a node's
        anchor-mapped timestamps) that bring all nodes onto the first
        node's timebase.  For each slot marked ``phase`` on both the
        reference node and another node, the timestamp delta estimates
        that node's skew; the median over shared slots is robust to the
        genuine ms-scale spread of externalization."""
        nodes = self.nodes()
        if not nodes:
            return {}
        ref = nodes[0]
        with self._lock:
            per_node_slot: Dict[str, Dict[int, float]] = {}
            for node in nodes:
                anchor = self._anchors.get(node)
                slots: Dict[int, float] = {}
                for m in self._marks.get(node, []):
                    if m.get("phase") == phase and "slot" in m:
                        # first mark per slot wins (re-marks are noise)
                        slots.setdefault(m["slot"],
                                         _mark_wall(m, anchor))
                per_node_slot[node] = slots
        offsets = {ref: 0.0}
        ref_slots = per_node_slot[ref]
        for node in nodes[1:]:
            deltas = [ref_slots[s] - t
                      for s, t in per_node_slot[node].items()
                      if s in ref_slots]
            offsets[node] = statistics.median(deltas) if deltas else 0.0
        return offsets

    # -- merging ------------------------------------------------------------
    def merge_chrome_trace(self) -> dict:
        """ONE Chrome trace document: pid per node (row-per-node in
        chrome://tracing / perfetto), span events + mark instant events
        shifted onto the aligned timebase, and per-slot flow arrows
        connecting each slot's marks across nodes."""
        with _registry().timer("fleet.trace.merge").time():
            return self._merge()

    def _merge(self) -> dict:
        nodes = self.nodes()
        offsets = self.align_offsets()
        events: List[dict] = []
        # slot -> [(ts_us, pid, tid)] for flow arrows
        slot_points: Dict[int, List[tuple]] = {}
        for pid, node in enumerate(nodes, start=1):
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": node}})
            events.append({"name": "process_sort_index", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"sort_index": pid}})
            off_us = offsets.get(node, 0.0) * 1e6
            with self._lock:
                anchor = self._anchors.get(node)
                spans = list(self._spans.get(node, []))
                marks = list(self._marks.get(node, []))
            for ev in spans:
                ev = dict(ev)
                ev["pid"] = pid
                ev["ts"] = round(ev.get("ts", 0.0) + off_us, 3)
                events.append(ev)
            for m in marks:
                ts_us = (_mark_wall(m, anchor)
                         + offsets.get(node, 0.0)) * 1e6
                tid = m.get("tid", 0)
                ev = {"name": f"{m.get('phase')}@{m.get('slot')}",
                      "ph": "i", "s": "t",
                      "ts": round(ts_us, 3),
                      "pid": pid, "tid": tid, "cat": "mark",
                      "args": {"slot": m.get("slot"),
                               "phase": m.get("phase"),
                               "node": node}}
                if m.get("args"):
                    ev["args"].update(m["args"])
                events.append(ev)
                if isinstance(m.get("slot"), int):
                    slot_points.setdefault(m["slot"], []).append(
                        (ev["ts"], pid, tid))
        # slot-spanning flow arrows: start at the slot's earliest mark,
        # step through every later mark (usually on other nodes)
        for slot, points in sorted(slot_points.items()):
            if len(points) < 2:
                continue
            points.sort()
            for i, (ts, pid, tid) in enumerate(points):
                ph = "s" if i == 0 else "f" if i == len(points) - 1 \
                    else "t"
                ev = {"name": "slot", "cat": "slot-flow", "ph": ph,
                      "id": slot, "ts": ts, "pid": pid, "tid": tid}
                if ph == "f":
                    ev["bp"] = "e"
                events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"nodes": nodes,
                             "offsets_s": {n: round(o, 6)
                                           for n, o in offsets.items()}}}

    def write_merged_trace(self, path: str) -> int:
        """Write the merged trace JSON to ``path``; returns the event
        count."""
        doc = self.merge_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


def merge_local_trace(path: str) -> int:
    """In-process fleet (chaos campaigns: N SimNodes in ONE process)
    variant: split THIS process's phase-mark buffer by each mark's node
    attribution into per-node rows, keep spans on a shared ``sim`` row,
    and write the same merged Chrome trace shape Fleet.finalize emits.
    Returns the event count."""
    from . import tracing
    doc = tracing.tracespans_doc(0)
    anchor = doc.get("anchor")
    coll = FleetTraceCollector()
    by_node: Dict[str, List[dict]] = {}
    for mark in doc.get("marks") or []:
        by_node.setdefault(mark.get("node") or "sim", []).append(mark)
    for node, marks in sorted(by_node.items()):
        coll.ingest(node, {"marks": marks, "anchor": anchor})
    if doc.get("spans"):
        coll.ingest("sim", {"spans": doc["spans"], "anchor": anchor})
    return coll.write_merged_trace(path)


# ---------------------------------------------------------------------------
# central metrics scraper
# ---------------------------------------------------------------------------

class FleetScraper:
    """Polls every node's metric snapshot on a cadence into a bounded
    ring per node (timestamped), derives SLO curves and per-node
    divergence deltas, and optionally drives a util/slo.SLOTracker with
    every node's snapshot (fleet-wide burn windows).

    With ``anomaly=True`` every scraped node gets its OWN
    util/anomaly.AnomalyDetector (gauge registration off — N nodes in
    one coordinator process must not fight over anomaly.active.*), fed
    each sweep; ``report()`` then carries per-node anomaly verdicts.
    ``retention_s`` bounds memory against nodes that leave the fleet
    for good: a node whose last successful scrape is older than the
    window is EVICTED (ring + detector dropped, ``fleet.scrape.evicted``
    counted).  A node that merely restarts inside the window keeps its
    history; an evicted node that re-appears starts a fresh ring."""

    # the standing fleet curves: (label, metric, field).  The last three
    # are the read-path contention axes: merge stall inside
    # close, reader-held pin time, and bulk-read key throughput — the
    # inputs to the close-p99-vs-read-QPS story.
    CURVES = (
        ("close_p99_s", "ledger.ledger.close", "p99_s"),
        ("admission_depth", "herder.admission.depth", "value"),
        ("shed_count", "herder.admission.overload", "count"),
        ("merge_stall_p99_s", "bucket.merge.stall", "p99_s"),
        ("pin_held_p99_s", "bucketlistdb.pin.held", "p99_s"),
        ("read_qps", "bucketlistdb.read.keys", "recent_rate"),
    )

    def __init__(self,
                 fetchers: Dict[str, Callable[[], dict]],
                 cadence_s: float = SCRAPE_CADENCE_S,
                 ring: int = SCRAPE_RING,
                 tracker=None,
                 retention_s: Optional[float] = None,
                 anomaly: bool = False):
        self._fetchers = dict(fetchers)
        self.cadence_s = cadence_s
        self.tracker = tracker
        self.retention_s = retention_s
        self.anomaly = anomaly
        self._ring_len = ring
        self._rings: Dict[str, deque] = {
            name: deque(maxlen=ring) for name in self._fetchers}
        # per-node last SUCCESSFUL scrape time (scraper-relative);
        # retention measures from scraper start for never-seen nodes
        self._last_ok: Dict[str, float] = {
            name: 0.0 for name in self._fetchers}
        self._detectors: Dict[str, object] = {}
        self._evicted = 0
        self._lock = make_lock("fleettrace.scraper")
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._polls = 0
        self._errors = 0
        self._t0 = monotonic_now()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetScraper":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop_evt = threading.Event()
                self._thread = threading.Thread(
                    target=self._run, name="fleet-scraper", daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop_evt.set()
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=max(2.0, 2 * self.cadence_s))

    def _run(self) -> None:
        with self._lock:
            evt = self._stop_evt
        while not evt.wait(self.cadence_s):
            self.sweep()

    # -- scraping -----------------------------------------------------------
    def sweep(self) -> int:
        """One pass over every node; returns the number of successful
        scrapes.  A node that fails to answer (killed by chaos, mid-
        restart) counts an error and keeps its ring as-is until the
        retention window (when set) expires it."""
        ok = 0
        reg = _registry()
        for name, fetch in self._fetchers.items():
            try:
                snap = fetch()
            except Exception:  # corelint: disable=exception-hygiene -- a killed node must not stop the sweep; the error counter carries the signal
                with self._lock:
                    self._errors += 1
                reg.counter("fleet.scrape.errors").inc()
                continue
            now = monotonic_now() - self._t0
            det = None
            with self._lock:
                # setdefault: an evicted node that re-appears rebuilds
                # its ring (and detector) from scratch
                self._rings.setdefault(
                    name, deque(maxlen=self._ring_len)).append((now, snap))
                self._last_ok[name] = now
                self._polls += 1
                if self.anomaly:
                    det = self._detectors.get(name)
                    if det is None:
                        from .anomaly import (AnomalyDetector,
                                              default_tracked)
                        det = AnomalyDetector(default_tracked(),
                                              source=name,
                                              register_gauges=False)
                        self._detectors[name] = det
            reg.counter("fleet.scrape.polls").inc()
            ok += 1
            # detector + tracker evaluate OUTSIDE the scraper lock (each
            # takes its own lock; ours must stay above theirs, not hold
            # them nested through fetch-heavy sweeps)
            if det is not None:
                det.evaluate(snap, now=now)
            if self.tracker is not None:
                self.tracker.evaluate(snap, now=now)
        self._evict_stale(monotonic_now() - self._t0)
        return ok

    def _evict_stale(self, now: float) -> None:
        """Drop ring + detector state for nodes whose last successful
        scrape is beyond the retention window — the memory bound against
        permanently-departed fleet members."""
        if self.retention_s is None:
            return
        reg = _registry()
        with self._lock:
            stale = [name for name, ring in self._rings.items()
                     if now - self._last_ok.get(name, 0.0)
                     > self.retention_s]
            for name in stale:
                del self._rings[name]
                self._detectors.pop(name, None)
                self._last_ok.pop(name, None)
                self._evicted += 1
        for _ in stale:
            reg.counter("fleet.scrape.evicted").inc()

    # -- readers ------------------------------------------------------------
    def ring(self, node: str) -> List[tuple]:
        with self._lock:
            return list(self._rings.get(node, ()))

    @staticmethod
    def _field(snap: dict, metric: str, field: str):
        m = snap.get(metric)
        return m.get(field) if isinstance(m, dict) else None

    def curve(self, metric: str, field: str) -> Dict[str, List[list]]:
        """Per-node [t_s, value] series for one metric field (points
        where the metric was absent are skipped)."""
        out: Dict[str, List[list]] = {}
        with self._lock:
            rings = {n: list(r) for n, r in self._rings.items()}
        for node, ring in rings.items():
            series = []
            for t, snap in ring:
                v = self._field(snap, metric, field)
                if v is not None:
                    series.append([round(t, 3), v])
            out[node] = series
        return out

    def curves(self) -> dict:
        return {label: self.curve(metric, field)
                for label, metric, field in self.CURVES}

    def divergence(self, metric: str, field: str) -> Optional[dict]:
        """Latest-snapshot spread of one metric field across nodes: the
        per-node values plus max-min delta — a straggler detector."""
        values: Dict[str, float] = {}
        with self._lock:
            for node, ring in self._rings.items():
                if not ring:
                    continue
                v = self._field(ring[-1][1], metric, field)
                if v is not None:
                    values[node] = v
        if not values:
            return None
        return {"values": values,
                "delta": round(max(values.values())
                               - min(values.values()), 6)}

    @property
    def polls(self) -> int:
        with self._lock:
            return self._polls

    @property
    def errors(self) -> int:
        with self._lock:
            return self._errors

    @property
    def evicted(self) -> int:
        with self._lock:
            return self._evicted

    def tracked_nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def node_anomalies(self) -> Dict[str, dict]:
        """Per-node anomaly verdicts (empty when anomaly=False)."""
        with self._lock:
            detectors = dict(self._detectors)
        # report() takes each detector's own lock — outside ours
        return {name: det.report()
                for name, det in sorted(detectors.items())}

    def report(self) -> dict:
        """The fleet-report section: curves, divergence deltas, scrape
        accounting, per-node anomaly verdicts, and (when a tracker is
        attached) the SLO report."""
        out = {
            "cadence_s": self.cadence_s,
            "polls": self.polls,
            "errors": self.errors,
            "evicted": self.evicted,
            "nodes": self.tracked_nodes(),
            "curves": self.curves(),
            "divergence": {
                label: self.divergence(metric, field)
                for label, metric, field in self.CURVES},
        }
        if self.anomaly:
            out["anomalies"] = self.node_anomalies()
        if self.tracker is not None:
            out["slo"] = self.tracker.report()
        return out
