"""Metrics registry: counters, meters, gauges, histograms and timers,
medida-style.

Reference: lib/libmedida as used throughout the reference
(`app.getMetrics().NewTimer({"ledger", "ledger", "close"})`, CommandHandler
/metrics endpoint).  Names are dotted strings ("ledger.ledger.close");
`registry().snapshot()` is the /metrics JSON surface and
`render_prometheus()` the `/metrics?format=prometheus` text exposition.

Naming scheme: dotted lowercase `layer.subsystem.event`; segments after the
first may use `-` (`herder.tx-queue.depth`).  Enforced by METRIC_NAME_RE and
the lint test (tests/test_observability.py); every instrumented name must be
in CANONICAL_METRICS or start with a CANONICAL_PREFIXES entry.

Timers/histograms sample through an exponential-decay reservoir (medida's
ExpDecaySample: size 1028, alpha 0.015 ≈ the trailing 5 minutes dominate),
so snapshots report p50/p90/p99 that track recent behavior, not the whole
process lifetime.
"""

from __future__ import annotations

import heapq
import math
import random
import re
import time
import weakref
from typing import Callable, Dict, List, Optional

from .clock import monotonic_now
from .lockorder import make_lock

METRIC_NAME_RE = re.compile(r"^[a-z0-9]+(\.[a-z0-9-]+)+$")

# The port's own names, beyond the reference's list: spans and timers
# where the benchmark's windows spend their host time (util/tracing), the
# trace buffer's eviction count and the collector's pauses.
PORT_METRICS = frozenset({
    "tracing.spans-evicted",
    "process.gc-pause",
    "herder.admission.flush-size",
    "herder.admission.flush-deadline",
    "herder.admission.flush-drain",
    "herder.admission.collect",
    "herder.admission.device-wait",
    "accel.ed25519.prep",
    "catchup.bucket-apply",
})

# The documented metric list (README.md §Observability).  The lint test
# walks the live registry after a simulated ledger close + catchup and
# asserts every recorded name is canonical; keep README and this list in
# sync when instrumenting new code.
CANONICAL_METRICS = frozenset({
    # ledger
    "ledger.ledger.close",
    "ledger.transaction.apply",
    "ledger.fee.process",
    # native live close (ledger/native_close.py): closes through the C
    # engine, per-close Python fallbacks/degrades, differential
    # spot-checks run — a silent fallback regression shows here
    "ledger.native.closes",
    "ledger.native.fallbacks",
    "ledger.native.differential-checks",
    # scp / herder
    "scp.envelope.receive",
    "scp.envelope.nominate",
    "scp.envelope.prepare",
    "scp.envelope.confirm",
    "scp.envelope.externalize",
    "scp.slot.externalize",
    "herder.ledger.externalize",
    "herder.tx-queue.depth",
    "herder.tx-queue.banned",
    "herder.scp.envelope-discarded",
    # admission (batched intake verification, herder/admission.py)
    "herder.admission.depth",
    "herder.admission.latency",
    "herder.admission.batch-size",
    "herder.admission.flush",
    "herder.admission.admitted",
    "herder.admission.rejected",
    "herder.admission.overload",
    "herder.admission.sigs-offloaded",
    # overlay
    "overlay.peer.drop",
    "overlay.peer.authenticated",
    "overlay.message.flood",
    "overlay.byte.read",
    "overlay.byte.write",
    "overlay.message.read",
    "overlay.message.write",
    "overlay.flood.duplicate",
    "overlay.flood.grant-deferred",
    # batched authenticated transport (overlay/peer.py): messages carried
    # in BATCHED_AUTH frames, coalesced-run flushes, and batch frame
    # bytes on the wire
    "overlay.batch.messages",
    "overlay.batch.flush",
    "overlay.batch.bytes",
    # catchup / historywork
    "catchup.download.checkpoint",
    "catchup.apply.checkpoint",
    "catchup.apply.ledger",
    "catchup.preverify.dispatch",
    "catchup.preverify.collect-wait",
    "catchup.preverify.sigs-total",
    "catchup.preverify.sigs-shipped",
    "catchup.preverify.fallback",
    # offload-miss watermark split (ISSUE 14): dispatched-but-late vs
    # never-dispatched — the two causes that used to share one counter —
    # plus groups whose verdicts ripened after their first checkpoint
    "catchup.preverify.race-lost",
    "catchup.preverify.not-dispatched",
    "catchup.preverify.late-seeded",
    # native-engine checkpoint outcomes (works.py): applied in C vs
    # probe-rejected to the Python oracle
    "catchup.native.checkpoint",
    "catchup.native.fallback",
    # range-parallel catchup (catchup/parallel.py)
    "catchup.parallel.ranges-inflight",
    "catchup.parallel.range-retry",
    "catchup.parallel.range-rate",
    "catchup.parallel.stitch-verified",
    # checkpoint-granular work stealing (ISSUE 14): accepted steals
    "catchup.parallel.steal",
    # bucket
    "bucket.merge.time",
    "bucket.merge.stream",
    "bucket.merge.bytes",
    # close-blocked-on-merge: time add_batch spent waiting for an
    # unresolved background merge before a spill commit (ISSUE 20
    # read-path contention observability)
    "bucket.merge.stall",
    "bucket.batch.addtime",
    "bucket.rehydrate",
    "bucket.rehydrate.entries",
    "bucket.resident.entries",
    # bucketlistdb (disk-backed ledger-entry reads)
    "bucketlistdb.load",
    "bucketlistdb.prefetch",
    "bucketlistdb.cache.hit",
    "bucketlistdb.cache.miss",
    # read-path contention counters (ISSUE 20): reader-held pin time per
    # snapshot, live pin count, and bulk-read key volume
    "bucketlistdb.pin.held",
    "bucketlistdb.pin.active",
    "bucketlistdb.read.keys",
    # accel
    "accel.ed25519.batch-size",
    "accel.ed25519.table-sigs",
    "accel.ed25519.generic-sigs",
    "accel.ed25519.rejected-prep",
    "accel.ed25519.tables-built",
    "accel.quorum.checks",
    "accel.quorum.nodes",
    "accel.quorum.frontier-peak",
    "accel.quorum.quorum-hits",
    # crypto
    "crypto.verify.cache-hit",
    "crypto.verify.recompute",
    # incident observability (flight recorder / health)
    "node.health",
    "eventlog.record.count",
    "log.bridge.records",
    # fleet observability plane (ISSUE 16): slot phase marks + the
    # cross-node collector/scraper (util/tracing, util/fleettrace)
    "fleet.trace.marks",
    "fleet.trace.merge",
    "fleet.scrape.polls",
    "fleet.scrape.errors",
    # retention bound (ISSUE 20): nodes absent beyond the scraper's
    # retention window get their history evicted
    "fleet.scrape.evicted",
    # always-on sampling profiler (util/sampleprof)
    "profile.sampler.samples",
    "profile.sampler.dropped",
    "profile.sampler.running",
    # SLO burn tracking (util/slo)
    "slo.eval.windows",
    "slo.burn.flips",
    # Soroban execution subsystem (ISSUE 17): bounded host, TTL
    # archival, footprint-clustered parallel apply
    "soroban.host.invoke",
    "soroban.host.trap",
    "soroban.host.budget-exceeded",
    "soroban.host.cpu-insns",
    "soroban.ttl.extend",
    "soroban.ttl.restore",
    "soroban.ttl.evicted",
    "soroban.apply.clusters",
    "soroban.apply.phase",
    "soroban.transaction.apply",
}) | PORT_METRICS

# Prefixes for families whose tail is data-dependent (one meter per overlay
# message type; one probe counter per bucket-list level; one burn-rate
# gauge per declared SLO objective; the retrospective-telemetry plane —
# time-series store, per-close cost ledger, anomaly detector — whose
# gauge tails carry series names).
CANONICAL_PREFIXES = ("overlay.recv.", "bucketlistdb.probe.",
                      "slo.objective.", "timeseries.", "closecost.",
                      "anomaly.")


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self) -> dict:
        return {"type": "counter", "count": self.value}


class Gauge:
    """Callable-backed instantaneous value (reference: medida gauges /
    the CommandHandler's point-in-time fields).  `set_source` replaces the
    callable — last registration wins, which is what multi-node simulations
    want (the registry is process-global)."""
    __slots__ = ("_fn",)

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._fn = fn

    def set_source(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def value(self) -> Optional[float]:
        """Current value, or None when the source is missing/raises — a
        gauge outliving its subsystem must not break the whole /metrics
        surface (and must not leak NaN into strict-JSON consumers)."""
        if self._fn is None:
            return None
        try:
            return float(self._fn())
        except Exception:  # corelint: disable=exception-hygiene -- dead gauge reads as null, never breaks /metrics
            return None

    def reset(self) -> None:
        pass  # gauges carry no recorded samples

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value()}


class Meter:
    """Event rate: count + events/sec over the process lifetime and a
    recent sliding window (medida meters' 1m rate approximated)."""
    __slots__ = ("count", "_t0", "_win_start", "_win_count", "_last_rate",
                 "_have_window")

    WINDOW = 60.0

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self._t0 = monotonic_now()
        self._win_start = self._t0
        self._win_count = 0
        self._last_rate = 0.0
        self._have_window = False

    def mark(self, n: int = 1) -> None:
        self.count += n
        self._win_count += n
        now = monotonic_now()
        if now - self._win_start >= self.WINDOW:
            self._last_rate = self._win_count / (now - self._win_start)
            self._win_start = now
            self._win_count = 0
            self._have_window = True

    def _recent_rate(self) -> float:
        """Rate over the trailing window, INCLUDING the in-progress one:
        the old behavior reported 0.0 until a full 60s window elapsed and
        then froze between marks."""
        now = monotonic_now()
        elapsed = now - self._win_start
        if elapsed >= self.WINDOW:
            # window overdue (no mark rolled it): everything we know about
            # the trailing period is the in-progress count
            return self._win_count / elapsed
        if not self._have_window:
            # first window: partial-window rate, elapsed floored at 1s so
            # a scrape landing moments after start (or /clearmetrics)
            # can't inflate one event into a ~1000/s spike
            return self._win_count / max(elapsed, 1.0)
        # blend the completed window with the in-progress fraction
        return (self._win_count
                + self._last_rate * (self.WINDOW - elapsed)) / self.WINDOW

    def snapshot(self) -> dict:
        lifetime = monotonic_now() - self._t0
        return {"type": "meter", "count": self.count,
                "mean_rate": round(self.count / lifetime, 3)
                if lifetime > 0 else 0.0,
                "recent_rate": round(self._recent_rate(), 3)}


class _ExpDecayReservoir:
    """Exponential-decay sample (medida ExpDecaySample / Cormode et al.):
    a fixed-size priority sample where newer values win with exponentially
    growing weight, so percentiles track recent behavior."""
    __slots__ = ("size", "alpha", "_heap", "_t0", "_next_rescale", "_rng")

    RESCALE_INTERVAL = 3600.0

    def __init__(self, size: int = 1028, alpha: float = 0.015) -> None:
        self.size = size
        self.alpha = alpha
        self._heap: List = []  # (priority, tiebreak, value)
        self._t0 = monotonic_now()
        self._next_rescale = self._t0 + self.RESCALE_INTERVAL
        self._rng = random.Random(0x5747)

    def update(self, value: float) -> None:
        now = monotonic_now()
        if now >= self._next_rescale:
            self._rescale(now)
        priority = math.exp(self.alpha * (now - self._t0)) \
            / max(self._rng.random(), 1e-12)
        item = (priority, self._rng.random(), value)
        if len(self._heap) < self.size:
            heapq.heappush(self._heap, item)
        elif priority > self._heap[0][0]:
            heapq.heapreplace(self._heap, item)

    def _rescale(self, now: float) -> None:
        # renormalize priorities so exp() stays in range on long uptimes
        factor = math.exp(-self.alpha * (now - self._t0))
        self._heap = [(p * factor, t, v) for p, t, v in self._heap]
        heapq.heapify(self._heap)
        self._t0 = now
        self._next_rescale = now + self.RESCALE_INTERVAL

    def values(self) -> List[float]:
        return [v for _, _, v in self._heap]

    def clear(self) -> None:
        self._heap = []


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class Histogram:
    """Value distribution with exponential-decay percentiles."""
    __slots__ = ("count", "total", "max", "min", "_reservoir", "_lock")

    def __init__(self) -> None:
        self._lock = make_lock("metrics.histogram")
        self._init_state()

    def _init_state(self) -> None:
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.min = float("inf")
        self._reservoir = _ExpDecayReservoir()

    def reset(self) -> None:
        with self._lock:
            self._init_state()

    def update(self, value: float) -> None:
        with self._lock:
            self.update_unlocked(value)

    def update_unlocked(self, value: float) -> None:
        """update() without the lock, for a histogram with one writer
        that may run while its own thread holds any lock (a gc
        callback)."""
        self.count += 1
        self.total += value
        if value > self.max:
            self.max = value
        if value < self.min:
            self.min = value
        self._reservoir.update(value)

    def quantiles(self) -> dict:
        with self._lock:
            vals = sorted(self._reservoir.values())
        return {"p50": _percentile(vals, 0.50),
                "p90": _percentile(vals, 0.90),
                "p99": _percentile(vals, 0.99)}

    def snapshot(self) -> dict:
        q = self.quantiles()
        return {"type": "histogram", "count": self.count,
                "mean": round(self.total / self.count, 6) if self.count
                else 0.0,
                "sum": round(self.total, 6),
                "max": round(self.max, 6),
                "min": round(self.min, 6) if self.count else 0.0,
                "p50": round(q["p50"], 6), "p90": round(q["p90"], 6),
                "p99": round(q["p99"], 6)}


class Timer(Histogram):
    """Histogram of durations in seconds; snapshot keys carry the _s unit
    suffix (the shape apply_load and the bench record expect)."""
    __slots__ = ()

    def time(self):
        return _TimerCtx(self)

    def snapshot(self) -> dict:
        q = self.quantiles()
        return {"type": "timer", "count": self.count,
                "mean_s": round(self.total / self.count, 6)
                if self.count else 0.0,
                "sum_s": round(self.total, 6),
                "max_s": round(self.max, 6),
                "min_s": round(self.min, 6) if self.count else 0.0,
                "p50_s": round(q["p50"], 6), "p90_s": round(q["p90"], 6),
                "p99_s": round(q["p99"], 6)}


class _TimerCtx:
    __slots__ = ("_timer", "_t0")

    def __init__(self, t: Timer):
        self._timer = t

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.update(time.perf_counter() - self._t0)


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        # creation is check-then-act and metrics record from background
        # threads (worker-pool bucket merges, the preverify device
        # worker): without the lock, concurrent first-touch of a name
        # makes two objects and silently drops one's samples
        self._lock = make_lock("metrics.registry")

    def _get(self, name: str, cls, exact: bool = False):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls()
        ok = type(m) is cls if exact else isinstance(m, cls)
        assert ok, f"{name} already a {type(m).__name__}"
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def lookup(self, name: str):
        """The metric `name`, or None where it was never made.  Takes no
        lock, for a caller that may run while its thread holds it (a gc
        callback)."""
        return self._metrics.get(name)

    def histogram(self, name: str) -> Histogram:
        # exact: a Timer IS-A Histogram but has a different snapshot shape
        return self._get(name, Histogram, exact=True)

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, Gauge)
        if fn is not None:
            g.set_source(fn)
        return g

    def weak_gauge(self, name: str, obj, fn: Callable) -> Gauge:
        """Gauge reading `fn(obj)` WITHOUT pinning `obj` in the
        process-global registry: once the subsystem is torn down the
        source reads null (fn(None) raises, Gauge.value() catches).
        This is how per-node gauges must register — a strong closure
        would retain a dead node's whole object graph for process
        lifetime."""
        ref = weakref.ref(obj)
        return self.gauge(name, lambda: fn(ref()))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def items(self) -> List[tuple]:
        """Sorted (name, metric) pairs — the change-aware capture path
        (util/timeseries) walks metric objects directly so it can skip
        snapshot recompute for provably-unchanged reservoirs."""
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, dict]:
        with self._lock:
            items = sorted(self._metrics.items())
        return {k: m.snapshot() for k, m in items
                if prefix is None or k.startswith(prefix)}

    def clear(self) -> None:
        """Reset every metric IN PLACE (reference: /clearmetrics).

        Deliberately not a dict replacement: call sites hold direct metric
        references (hot paths cache `registry().timer(...)` lookups), and
        replacing the mapping orphaned those objects — every sample after a
        /clearmetrics silently vanished."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()


# Made with each process registry, so that its writer only looks it up:
# a gc callback (util.tracing) may run while its thread holds the
# registry's lock, and cannot make a metric.
GC_PAUSE_TIMER = "process.gc-pause"


def _process_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.timer(GC_PAUSE_TIMER)
    return reg


_registry = _process_registry()


def registry() -> MetricsRegistry:
    """The process-wide registry (reference: medida::MetricsRegistry owned
    by the Application; module-global here because LedgerManager and friends
    are constructible without an Application)."""
    return _registry


def reset_registry() -> None:
    global _registry
    _registry = _process_registry()


# ---------------------------------------------------------------------------
# Prometheus text exposition (reference shape: the v20+ CommandHandler
# /metrics alternatives; format per prometheus.io/docs/instrumenting/
# exposition_formats).
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_val(v) -> str:
    if v is None or v != v:  # dead gauge / NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v)) if not float(v).is_integer() else str(int(v))


def render_prometheus(snapshot: Dict[str, dict],
                      namespace: str = "stellar_core_tpu") -> str:
    """Render a registry snapshot in Prometheus text exposition format.

    counters/meters -> `<ns>_<name>_total` counters (meters also export a
    `_rate` gauge); gauges -> gauges; timers/histograms -> summaries with
    quantile labels plus `_sum`/`_count` (timers in seconds)."""
    lines: List[str] = []

    def emit(name: str, mtype: str, samples: List) -> None:
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lines.append(f"{name}{labels} {_prom_val(value)}")

    for raw_name, snap in sorted(snapshot.items()):
        base = f"{namespace}_{_prom_name(raw_name)}"
        t = snap.get("type")
        if t == "counter":
            emit(base + "_total", "counter", [("", snap["count"])])
        elif t == "meter":
            emit(base + "_total", "counter", [("", snap["count"])])
            emit(base + "_rate", "gauge", [("", snap["recent_rate"])])
        elif t == "gauge":
            emit(base, "gauge", [("", snap["value"])])
        elif t == "timer":
            emit(base + "_seconds", "summary", [
                ('{quantile="0.5"}', snap["p50_s"]),
                ('{quantile="0.9"}', snap["p90_s"]),
                ('{quantile="0.99"}', snap["p99_s"]),
            ])
            # exact accumulated total, NOT mean*count — rounded means
            # drift non-monotonically at high sample counts and Prometheus
            # rate() reads a decreasing _sum as a counter reset
            lines.append(f"{base}_seconds_sum {_prom_val(snap['sum_s'])}")
            lines.append(f"{base}_seconds_count {snap['count']}")
            emit(base + "_seconds_max", "gauge", [("", snap["max_s"])])
        elif t == "histogram":
            emit(base, "summary", [
                ('{quantile="0.5"}', snap["p50"]),
                ('{quantile="0.9"}', snap["p90"]),
                ('{quantile="0.99"}', snap["p99"]),
            ])
            lines.append(f"{base}_sum {_prom_val(snap['sum'])}")
            lines.append(f"{base}_count {snap['count']}")
            emit(base + "_max", "gauge", [("", snap["max"])])
    return "\n".join(lines) + "\n"
