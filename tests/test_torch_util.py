"""The port's util copies against the JAX package's, on the same inputs.

Each test runs one scenario, made from a seed, through
stellar_core_tpu.util.<module> and stellar_core_tpu_torch.util.<module>
and requires the same results, exactly: metric snapshots and the
Prometheus text, VirtualClock firing order and final now(), cache
evictions, lock-order and data-race verdicts, spans, flight events,
determinism-guard trips, rate limiting and slow-scope timers.  Wall and
monotonic times are either faked (the same sequence on both sides) or
masked.  The registry and the flight recorder are global to the process,
so the scenarios use fresh objects or deltas.
"""

import logging
import random
import threading
import time

import pytest

from stellar_core_tpu.util import assertions as r_assertions
from stellar_core_tpu.util import cache as r_cache
from stellar_core_tpu.util import clock as r_clock
from stellar_core_tpu.util import detguard as r_detguard
from stellar_core_tpu.util import eventlog as r_eventlog
from stellar_core_tpu.util import lockorder as r_lockorder
from stellar_core_tpu.util import logging as r_logging
from stellar_core_tpu.util import metrics as r_metrics
from stellar_core_tpu.util import perf as r_perf
from stellar_core_tpu.util import racetrace as r_racetrace
from stellar_core_tpu.util import scheduler as r_scheduler
from stellar_core_tpu.util import tracing as r_tracing
from stellar_core_tpu_torch.util import assertions as p_assertions
from stellar_core_tpu_torch.util import cache as p_cache
from stellar_core_tpu_torch.util import clock as p_clock
from stellar_core_tpu_torch.util import detguard as p_detguard
from stellar_core_tpu_torch.util import eventlog as p_eventlog
from stellar_core_tpu_torch.util import lockorder as p_lockorder
from stellar_core_tpu_torch.util import logging as p_logging
from stellar_core_tpu_torch.util import metrics as p_metrics
from stellar_core_tpu_torch.util import perf as p_perf
from stellar_core_tpu_torch.util import racetrace as p_racetrace
from stellar_core_tpu_torch.util import scheduler as p_scheduler
from stellar_core_tpu_torch.util import tracing as p_tracing


def both(scenario, ref, port, *args):
    """scenario(module, *args) on the reference and on the port: equal."""
    want = scenario(ref, *args)
    got = scenario(port, *args)
    assert got == want
    return got


class FakeClock:
    """A monotonic clock that a scenario advances by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# -- metrics -----------------------------------------------------------------

def metrics_scenario(m, seed, monkeypatch):
    clk = FakeClock()
    monkeypatch.setattr(m, "monotonic_now", clk)
    reg = m.MetricsRegistry()
    rng = random.Random(seed)
    gauge_value = [0.0]
    reg.gauge("herder.tx-queue.depth", lambda: gauge_value[0])
    reg.gauge("node.health", lambda: 1 / 0)          # a dead gauge reads null
    snaps = []
    for step in range(400):
        op = rng.randrange(6)
        if op == 0:
            reg.counter(f"accel.ed25519.c{rng.randrange(3)}").inc(
                rng.randrange(1, 50))
        elif op == 1:
            reg.meter("overlay.message.read").mark(rng.randrange(1, 9))
        elif op == 2:
            reg.histogram("accel.ed25519.batch-size").update(
                rng.randrange(1, 65536))
        elif op == 3:
            reg.timer("ledger.ledger.close").update(rng.random())
        elif op == 4:
            gauge_value[0] = rng.random() * 100
        else:
            # the window (60 s) and the reservoir's rescale (3600 s) roll
            clk.t += rng.choice((0.5, 7.0, 61.0, 3601.0))
        if step % 50 == 49:
            snaps.append(reg.snapshot())
    snaps.append(reg.snapshot(prefix="accel."))
    prom = m.render_prometheus(reg.snapshot())
    reg.clear()
    return snaps, prom, reg.snapshot(), reg.names()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_snapshots_and_prometheus(seed, monkeypatch):
    snaps, prom, cleared, names = both(metrics_scenario, r_metrics, p_metrics,
                                       seed, monkeypatch)
    assert snaps[-2]["ledger.ledger.close"]["count"] > 0
    assert "stellar_core_tpu_ledger_ledger_close_seconds_count" in prom
    assert cleared["ledger.ledger.close"]["count"] == 0


def test_metrics_name_rules_and_type_clash():
    # the reference's list, and the port's own names beside it
    assert p_metrics.CANONICAL_METRICS \
        == r_metrics.CANONICAL_METRICS | p_metrics.PORT_METRICS
    assert not p_metrics.PORT_METRICS & r_metrics.CANONICAL_METRICS
    assert p_metrics.CANONICAL_PREFIXES == r_metrics.CANONICAL_PREFIXES
    assert p_metrics.METRIC_NAME_RE.pattern == r_metrics.METRIC_NAME_RE.pattern

    def clash(m):
        reg = m.MetricsRegistry()
        reg.timer("ledger.ledger.close")
        with pytest.raises(AssertionError) as e:
            reg.histogram("ledger.ledger.close")
        return str(e.value)

    both(clash, r_metrics, p_metrics)


def test_timer_context_uses_perf_counter(monkeypatch):
    ticks = iter([10.0, 10.25, 20.0, 21.5])

    def run(m):
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        reg = m.MetricsRegistry()
        for _ in range(2):
            with reg.timer("catchup.apply.ledger").time():
                pass
        monkeypatch.undo()
        return reg.snapshot()

    want = run(r_metrics)
    ticks = iter([10.0, 10.25, 20.0, 21.5])
    assert run(p_metrics) == want


# -- clock and scheduler -----------------------------------------------------

def clock_scenario(c, s, seed):
    clock = c.VirtualClock(c.ClockMode.VIRTUAL_TIME)
    rng = random.Random(seed)
    fired = []
    timers = []
    for i in range(40):
        t = c.VirtualTimer(clock)
        delay = rng.choice((0.0, 0.5, 1.0, 2.5, 10.0)) + rng.randrange(5)
        if i % 3 == 0:
            t.expires_at(delay, lambda i=i: fired.append(("at", i, clock.now())))
        else:
            t.expires_from_now(delay, lambda i=i: fired.append(
                ("timer", i, clock.now())))
        timers.append(t)
    for i in rng.sample(range(40), 8):
        timers[i].cancel()
    for q in range(30):
        name = f"q{rng.randrange(3)}"
        clock.post_action(lambda q=q, name=name: fired.append(
            ("action", name, q, clock.now())), name=name)
    seated = [t.seated for t in timers]
    steps = [clock.crank() for _ in range(5)]
    until = clock.crank_until(lambda: len(fired) >= 45, timeout=3.0)
    clock.crank_for(100.0)
    sched = s.Scheduler()
    for q in range(s.MAX_QUEUE_DEPTH + 5):
        sched.enqueue(lambda: None, name="drop", queue_type=s.ACTION_DROPPABLE)
    ran = sched.run_one_batch(max_actions=7)
    return (fired, seated, steps, until, clock.now(), clock.system_now(),
            sched.dropped, sched.size(), ran)


@pytest.mark.parametrize("seed", [3, 4])
def test_virtual_clock_fires_in_the_same_order(seed):
    want = clock_scenario(r_clock, r_scheduler, seed)
    got = clock_scenario(p_clock, p_scheduler, seed)
    assert got == want
    assert len(want[0]) > 40 and want[6] == 5


# -- cache -------------------------------------------------------------------

def cache_scenario(m, seed):
    rng = random.Random(seed)
    rc = m.RandomEvictionCache(16, rng=random.Random(seed + 100))
    lru = m.LRUCache(16)
    log = []
    for _ in range(500):
        k = rng.randrange(48)
        if rng.random() < 0.6:
            rc.put(k, k * 3)
            lru.put(k, k * 5)
        else:
            log.append((rc.get(k), rc.maybe_get(k), lru.get(k)))
        log.append((sorted(rc._map), list(lru._map)))
    return log, rc.hits, rc.misses, len(rc), lru.hit_rate(), k in rc


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_random_eviction_cache_evicts_alike(seed):
    log, hits, misses, size, _, _ = both(cache_scenario, r_cache, p_cache, seed)
    assert size == 16 and hits and misses


def test_default_cache_rng_and_errors():
    def run(m):
        rc = m.RandomEvictionCache(3)
        for k in range(20):
            rc.put(k, k)
        with pytest.raises(ValueError):
            m.RandomEvictionCache(0)
        return sorted(rc._map)

    both(run, r_cache, p_cache)


# -- lock order ----------------------------------------------------------------

def lockorder_scenario(lo, orderings):
    prev = lo.enabled()
    lo.enable()
    lo.reset_observed()
    verdicts = []
    try:
        locks = {n: lo.make_lock(n) for n in "abcd"}
        locks["r"] = lo.make_rlock("r")
        for seq in orderings:
            held = []
            try:
                for n in seq:
                    locks[n].acquire()
                    held.append(n)
                verdicts.append(("ok", lo.held_locks()))
            except lo.LockOrderError as e:
                verdicts.append(("inversion", str(e)))
            finally:
                for n in reversed(held):
                    locks[n].release()
        edges = lo.observed_edges()
    finally:
        lo.reset_observed()
        if not prev:
            lo.disable()
    return verdicts, edges


@pytest.mark.parametrize("orderings", [
    ["ab", "bc", "ca"],                 # a 3-cycle
    ["ab", "ba"],                       # ABBA
    ["abc", "ac", "bd", "db"],
    ["rr", "ra", "ar"],                 # reentrant re-entry, then ABBA
    ["aa"],                             # non-reentrant re-acquire
])
def test_lock_order_verdicts(orderings):
    verdicts, _ = both(lockorder_scenario, r_lockorder, p_lockorder, orderings)
    assert any(v[0] == "inversion" for v in verdicts)


def test_lock_order_disabled_makes_plain_locks():
    def run(lo):
        prev = lo.enabled()
        lo.disable()
        try:
            return type(lo.make_lock("x")).__name__, lo.held_locks()
        finally:
            if prev:
                lo.enable()

    both(run, r_lockorder, p_lockorder)


# -- data races ----------------------------------------------------------------

def _in_thread(fn, name):
    box = {}

    def wrap():
        try:
            box["r"] = fn()
        except BaseException as e:  # noqa: BLE001 - carried to the caller
            box["e"] = e

    t = threading.Thread(target=wrap, name=name)
    t.start()
    t.join(10.0)
    assert not t.is_alive()
    return box.get("r"), box.get("e")


def race_scenario(rt, lo):
    prev_race, prev_lock = rt.enabled(), lo.enabled()
    rt.enable()
    try:
        @rt.race_checked(ignore=("quiet",))
        class Box:
            def __init__(self):
                self._lock = lo.make_lock("test.box")
                self.x = 0
                self.quiet = 0

        out = []
        b = Box()
        b.x = 1
        b.quiet = 1
        _, err = _in_thread(lambda: setattr(b, "quiet", 2), "ignored")
        out.append(("ignored", err))

        def guarded():
            with b._lock:
                b.x = 2
        with b._lock:
            b.x = 3
        out.append(("guarded", _in_thread(guarded, "writer-1")[1]))
        out.append(("state", rt.field_state(b, "x")))
        _, err = _in_thread(lambda: setattr(b, "x", 4), "writer-2")
        out.append(("unguarded", type(err).__name__, str(err)))
        c = Box()
        for i in range(5):
            c.x = i                          # exclusive: no obligation
        out.append(("exclusive", rt.field_state(c, "x")))
        _, err = _in_thread(lambda: c.x, "reader")
        out.append(("read", err, rt.field_state(c, "x")))
        return out
    finally:
        if not prev_race:
            rt.disable()
        if not prev_lock:
            lo.disable()


def test_race_sanitizer_verdicts():
    want = race_scenario(r_racetrace, r_lockorder)
    got = race_scenario(p_racetrace, p_lockorder)
    assert got == want
    assert want[3][1] == "DataRaceError" and "Box.x" in want[3][2]
    assert want[1][1] is None


# -- tracing -------------------------------------------------------------------

def _masked_events(doc):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "tid")}
            for ev in doc["traceEvents"]]


def tracing_scenario(t, seed):
    rng = random.Random(seed)
    t.trace_buffer().clear()
    stacks = []
    with t.span("catchup.apply-checkpoint", checkpoint=63):
        for ledger in range(3):
            with t.span("ledger.close", seq=ledger, obj=object.__name__):
                t.annotate(txs=rng.randrange(100))
                for _ in range(t.MAX_CHILD_SPANS + 3 * ledger):
                    with t.span("tx.apply"):
                        pass
                with t.span("ledger.seal", data=b"x"):
                    stacks.append([(s["name"], s["args"])
                                   for s in t.active_span_stack()])
    root = t.trace_buffer().roots()[-1]

    def shape(s):
        return (s.name, s.args, s.truncated, [shape(c) for c in s.children])

    mark = t.mark_phase("nominate", 7, node="n1", round=2)
    mark_doc = {k: v for k, v in mark.to_dict().items()
                if k not in ("seq", "perf_s", "wall_s")}
    mark_events = [{k: v for k, v in ev.items() if k not in ("ts", "tid")}
                   for ev in t.mark_chrome_events([mark])]
    return (shape(root), root.depth(), stacks,
            _masked_events(t.to_chrome_trace([root])),
            _masked_events(t.to_chrome_trace([root], slot=1)),
            _masked_events(t.to_chrome_trace([root], slot=99)),
            t.jsonable_args({"a": 1, "b": [1], "c": None}), mark_doc,
            mark_events, t.current_span())


@pytest.mark.parametrize("seed", [8, 9])
def test_spans_and_chrome_export(seed):
    shape, depth, *_ = both(tracing_scenario, r_tracing, p_tracing, seed)
    assert depth == 3
    assert shape[3][2][2] == 7    # the third ledger: 6 tx spans, the seal elided


# -- flight recorder -----------------------------------------------------------

def _masked_flight(docs):
    return [{k: v for k, v in d.items()
             if k not in ("mono_s", "wall_s", "span_id")} for d in docs]


def fresh_recorder(ev, lg, monkeypatch):
    """A fresh flight recorder and no bundle sources or node id: the
    process-wide ones carry whatever earlier tests of this process left."""
    monkeypatch.setattr(ev, "_log", ev.EventLog())
    monkeypatch.setattr(ev, "_bundle_sources", {})
    monkeypatch.setattr(lg, "_node_id", None)
    ev.register_bundle_source("config", lambda: {"passphrase": "x"})
    ev.register_bundle_source("herder", lambda: 1 / 0)     # reports its error


def eventlog_scenario(ev, t, seed):
    rng = random.Random(seed)
    log = ev.EventLog(capacity=8)
    for i in range(12):
        log.record(rng.choice(("Ledger", "SCP", "Herder")),
                   rng.choice(("INFO", "WARNING")), f"event {i}",
                   {"i": i, "obj": [i]} if i % 2 else None)
    with t.span("ledger.close"):
        log.record("Ledger", "INFO", "in a span")
        in_span = log.events()[-1].span_id is not None
    recorder = ev.event_log()
    ev.record("Process", "warning", "lower-case severity", k=1)
    with pytest.raises(ValueError):
        ev.record("NoSuchPartition", "INFO", "x")
    bridge = ev.bridge_handler()
    bridge.emit(logging.LogRecord("stellar.Overlay", logging.ERROR, __file__,
                                  1, "peer %s dropped", ("p1",), None))
    added = _masked_flight(recorder.snapshot())
    bundle = ev.flight_bundle("why")
    return (len(log), _masked_flight(log.snapshot()), in_span, added,
            sorted(bundle), bundle["reason"], bundle["config"],
            bundle["herder"], ev.write_crash_bundle("x"))


@pytest.mark.parametrize("seed", [10, 11])
def test_flight_events(seed, monkeypatch):
    monkeypatch.delenv("STPU_CRASH_DIR", raising=False)
    fresh_recorder(r_eventlog, r_logging, monkeypatch)
    fresh_recorder(p_eventlog, p_logging, monkeypatch)
    want = eventlog_scenario(r_eventlog, r_tracing, seed)
    got = eventlog_scenario(p_eventlog, p_tracing, seed)
    assert got == want
    assert want[0] == 8 and want[2]
    assert [a["severity"] for a in want[3]] == ["WARNING", "ERROR"]


def test_crash_bundle_written_alike(tmp_path, monkeypatch):
    import json
    fresh_recorder(r_eventlog, r_logging, monkeypatch)
    fresh_recorder(p_eventlog, p_logging, monkeypatch)

    def run(ev, sub):
        path = ev.write_crash_bundle("reason r", crash_dir=str(tmp_path / sub))
        with open(path) as f:
            doc = json.load(f)
        return sorted(doc), doc["reason"], doc["thread"], doc["herder"]

    assert run(r_eventlog, "r") == run(p_eventlog, "p")


# -- determinism guard ---------------------------------------------------------

def detguard_scenario(dg, monkeypatch):
    monkeypatch.setattr(dg, "_TRIPPING_ROOTS", ("test_torch_util",))
    monkeypatch.delenv("STPU_CRASH_DIR", raising=False)
    dg.reset_stats()
    dg.enable()
    out = []
    try:
        seeded = random.Random(5)
        out.append(("outside", time.time() > 0, dg.current_region()))
        with dg.region("ledger-close"):
            with dg.region("soroban-apply"):
                out.append(("nested", dg.current_region()))
            out.append(("seeded", seeded.random()))
            out.append(("int-hash", hash(7)))
            for call, name in ((time.time, "time"), (random.random, "random"),
                               (lambda: hash("x"), "hash"),
                               (time.monotonic, "monotonic")):
                try:
                    call()
                    out.append((name, "no trip"))
                except dg.DeterminismError as e:
                    out.append((name, str(e)))
        out.append(("stats", dg.stats(), dg.enabled()))
    finally:
        dg.disable()
        dg.reset_stats()
    out.append(("disarmed", dg.enabled(), time.time is not None))
    return out


def test_determinism_guard_trips_alike(monkeypatch):
    want = detguard_scenario(r_detguard, monkeypatch)
    got = detguard_scenario(p_detguard, monkeypatch)
    assert got == want
    assert sum(1 for o in want if "nondeterministic" in str(o[-1])) == 4


def test_determinism_guard_trips_on_its_own_package(monkeypatch):
    """Unwidened, each guard trips on its own package's code: a random
    key (crypto/keys.py reads os.urandom) inside a region."""
    from stellar_core_tpu.crypto import keys as r_keys
    from stellar_core_tpu_torch.crypto import keys as p_keys
    monkeypatch.delenv("STPU_CRASH_DIR", raising=False)
    assert p_detguard._TRIPPING_ROOTS == ("stellar_core_tpu_torch",)

    def run(dg, keys):
        dg.enable()
        try:
            keys.SecretKey.random()              # outside a region
            with dg.region("ledger-close"):
                with pytest.raises(dg.DeterminismError) as e:
                    keys.SecretKey.random()
            return str(e.value), dg.stats()["trips"]
        finally:
            dg.disable()
            dg.reset_stats()

    assert run(p_detguard, p_keys) == run(r_detguard, r_keys)


# -- logging -------------------------------------------------------------------

def rate_limit_scenario(lg, seed):
    rng = random.Random(seed)
    lg.reset_rate_limits()
    log = lg.get("Herder")
    out = []
    prev = lg.node_id()
    lg.set_node_id(None)
    try:
        for i in range(200):
            if i == 120:
                lg.set_node_id("node-b")
            key = f"k{rng.randrange(3)}"
            emit, n = lg.rate_limited(log, key, every_n=rng.choice((5, 16)))
            out.append((key, n, emit.__name__))
            if i == 150:
                lg.discard_rate_limit("k0")
    finally:
        lg.set_node_id(prev)
        lg.reset_rate_limits()
    rec = logging.LogRecord("stellar.Ledger", logging.INFO, __file__, 1,
                            "closed %d", (5,), None)
    rec.created = 1234.5678
    with pytest.raises(ValueError):
        lg.get("NoSuchPartition")
    with pytest.raises(ValueError):
        lg.set_format("yaml")
    return (out, lg.JsonFormatter().format(rec), lg.PARTITIONS,
            lg.LOG_FORMATS, lg.current_format())


@pytest.mark.parametrize("seed", [12, 13])
def test_rate_limiting_and_json_records(seed):
    out, line, *_ = both(rate_limit_scenario, r_logging, p_logging, seed)
    assert {e for _, _, e in out} == {"warning", "debug"}
    assert '"partition": "Ledger"' in line


# -- assertions and perf -------------------------------------------------------

def test_release_asserts():
    def run(a):
        out = []
        a.release_assert(True)
        a.release_assert_or_throw(True, KeyError)
        for call in (lambda: a.release_assert(False),
                     lambda: a.release_assert(False, "m"),
                     lambda: a.release_assert_or_throw(False),
                     lambda: a.release_assert_or_throw(False, KeyError, "k")):
            with pytest.raises(Exception) as e:
                call()
            out.append((type(e.value).__name__, str(e.value),
                        isinstance(e.value, AssertionError)))
        return out

    both(run, r_assertions, p_assertions)


def perf_scenario(pf, mt, monkeypatch, caplog):
    reg = mt.MetricsRegistry()
    monkeypatch.setattr(pf, "registry", lambda: reg)
    ticks = iter([0.0, 0.5, 1.0, 3.0, 5.0, 5.1, 6.0, 9.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    pf.set_slow_threshold("catchup.download.checkpoint", 0.2)
    caplog.clear()
    try:
        with caplog.at_level(logging.WARNING, logger="stellar.Perf"):
            with pf.scoped_timer("catchup.download.checkpoint"):
                pass                                     # 0.5 s > 0.2 s
            with pf.scoped_timer("ledger.ledger.close"):
                pass                                     # 2.0 s > 1 s
            with pf.scoped_timer("ledger.ledger.close", slow_threshold=None):
                pass
            pf.set_slow_threshold("catchup.download.checkpoint", None)
            with pf.scoped_timer("catchup.download.checkpoint"):
                pass                                     # 3.0 s > 1 s
    finally:
        monkeypatch.undo()
    thresholds = pf.slow_threshold_for("x"), pf.DEFAULT_SLOW_THRESHOLD
    return ([r.getMessage() for r in caplog.records], reg.snapshot(),
            thresholds)


def test_scoped_timer_and_slow_warnings(monkeypatch, caplog):
    want = perf_scenario(r_perf, r_metrics, monkeypatch, caplog)
    got = perf_scenario(p_perf, p_metrics, monkeypatch, caplog)
    assert got == want
    assert len(want[0]) == 3
