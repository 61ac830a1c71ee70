"""The port's tracing over a benchmark window (util/tracing.py): the span
budget, eviction, the time_ns clock of spans_between, and the spans,
timers and counters placed where the host's time goes (/tx's crank-loop
wait, admission's flushes and collects, the verify prep, the bucket
apply, the collector's pauses)."""

import gc
import threading
import time

import pytest

from stellar_core_tpu_torch.util import metrics, tracing


@pytest.fixture(autouse=True)
def fresh_buffer(monkeypatch):
    """A trace buffer of this test's own.  Threads an earlier test left
    running (a device worker still verifying) may record into it too, so
    the tests pick their spans by name, thread or time."""
    buf = tracing.TraceBuffer()
    monkeypatch.setattr(tracing, "_buffer", buf)
    return buf


def timer_count(name: str) -> int:
    return metrics.registry().timer(name).count


def counter(name: str) -> int:
    return metrics.registry().counter(name).value


def count_spans(root, pred) -> int:
    n, stack = 0, [root]
    while stack:
        s = stack.pop()
        n += pred(s)
        stack.extend(s.children)
    return n


def test_budget_keeps_every_close_and_elides_leaves_only(fresh_buffer):
    """A pass of 16 closes, each with 1,000 tx.apply leaves: every close
    survives, and only leaves are elided, each counted once."""
    with tracing.span("catchup.apply-checkpoint", checkpoint=63) as root:
        for seq in range(16):
            with tracing.span("ledger.close", seq=seq):
                with tracing.span("ledger.tx-apply"):
                    for _ in range(1000):
                        with tracing.span("tx.apply"):
                            pass
                with tracing.span("ledger.seal"):
                    with tracing.span("bucket.snapshot"):
                        pass
    closes = [c for c in root.children if c.name == "ledger.close"]
    assert [c.args["seq"] for c in closes] == list(range(16))
    for c in closes:
        assert [k.name for k in c.children] == ["ledger.tx-apply",
                                                 "ledger.seal"]
        apply_ = c.children[0]
        assert len(apply_.children) + apply_.truncated == 1000
        assert len(apply_.children) <= tracing.MAX_CHILD_SPANS
    # the tree's leaf budget ran out in the eighth close: later closes
    # keep their tx-apply and seal spans (which had children), no leaves
    leaves = count_spans(root, lambda s: not s.children and not s.truncated)
    assert leaves == tracing.MAX_TREE_SPANS
    assert closes[-1].children[0].children == []
    assert closes[-1].children[0].truncated == 1000
    assert closes[-1].children[1].truncated == 1   # the elided snapshot
    elided = count_spans(root, lambda s: s.truncated)
    assert elided == 16 * 1001 - tracing.MAX_TREE_SPANS
    assert root in fresh_buffer.roots()
    assert root.size() == 1 + 16 * 3 + tracing.MAX_TREE_SPANS


def _tree(name: str, leaves: int, **args):
    root = tracing.Span(name, args)
    for _ in range(leaves):
        root.children.append(tracing.Span("tx.apply", parent=root))
    return root


def test_eviction_moves_the_counter():
    buf = tracing.TraceBuffer(max_spans=10)
    before = counter("tracing.spans-evicted")
    for i in range(4):
        buf.record(_tree("ledger.close", 3, seq=i))
    # trees of 4 spans: two fit, the two oldest were evicted
    assert [r.args["seq"] for r in buf.roots()] == [2, 3]
    assert buf.spans() == 8
    assert counter("tracing.spans-evicted") - before == 8
    buf.record(_tree("http.tx", 0))
    assert [r.name for r in buf.roots()] == ["ledger.close",
                                             "ledger.close", "http.tx"]
    assert buf.spans() == 9
    assert counter("tracing.spans-evicted") - before == 8
    # the newest tree stays, whatever its size
    buf.record(_tree("catchup.apply-checkpoint", 20))
    assert [r.name for r in buf.roots()] == ["catchup.apply-checkpoint"]
    assert buf.spans() == 21
    assert counter("tracing.spans-evicted") - before == 17


def test_spans_between_clips_to_its_window_on_the_time_ns_clock():
    probe = "tracing-window.probe"
    w0 = time.time_ns()
    with tracing.span(probe, checkpoint=7):
        time.sleep(0.02)
    w1 = time.time_ns()
    with tracing.span("tracing-window.other"):
        pass
    [(a, b, args)] = tracing.spans_between(0, 2 ** 63, probe)
    assert args == {"checkpoint": 7}
    # the span lies between the two time_ns readings around it
    assert w0 - 50_000 <= a < b <= w1 + 50_000
    assert b - a >= 20_000_000
    # each read maps through a fresh perf/wall pair: within 50 us
    mid = (a + b) // 2
    [(lo, hi, _)] = tracing.spans_between(mid, 2 ** 63, probe)
    assert lo == mid and abs(hi - b) < 50_000
    [(lo, hi, _)] = tracing.spans_between(0, mid, probe)
    assert abs(lo - a) < 50_000 and hi == mid
    assert tracing.spans_between(b + 100_000, 2 ** 63, probe) == []
    assert tracing.spans_between(0, a - 100_000, probe) == []
    assert [x[2] for x in tracing.spans_between(0, 2 ** 63,
                                                "tracing-window.other")] \
        == [{}]
    # the Chrome export stamps on the same clock
    doc = tracing.to_chrome_trace()
    ev = next(e for e in doc["traceEvents"] if e["name"] == probe)
    assert abs(ev["ts"] * 1e3 - a) < 50_000
    anchor = tracing.clock_anchor()
    assert abs(anchor["wall_s"] * 1e9 - time.time_ns()) < 50_000_000


def test_spans_between_reads_nested_spans_in_start_order():
    with tracing.span("tracing-window.pass"):
        for seq in range(3):
            with tracing.span("tracing-window.close", seq=seq):
                with tracing.span("tx.apply"):
                    pass
    got = tracing.spans_between(0, 2 ** 63, "tracing-window.close")
    assert [args["seq"] for _, _, args in got] == [0, 1, 2]
    assert all(a < b for a, b, _ in got)


class _BusyLoop:
    """A crank loop that is held busy for `busy_s` before it runs the
    action posted to it."""

    def __init__(self, busy_s: float):
        self.busy_s = busy_s
        self.threads = []

    def post_action(self, fn, name=None):
        def run():
            time.sleep(self.busy_s)
            fn()
        t = threading.Thread(target=run, daemon=True)
        self.threads.append(t)
        t.start()


def test_tx_span_carries_the_crank_loop_wait():
    from stellar_core_tpu_torch.main.http_admin import CommandHandler

    class App:
        clock = _BusyLoop(0.25)

        def submit_tx(self, blob):
            time.sleep(0.05)
            return {"status": "PENDING", "blob": blob.hex()}

    out = CommandHandler(App(), 0)._submit_tx_on_main(b"\x01\x02")
    assert out == {"status": "PENDING", "blob": "0102"}
    [root] = [r for r in tracing.trace_buffer().roots()
              if r.tid == threading.get_ident()]
    assert root.name == "http.tx" and root.children == []
    assert 0.25 <= root.args["wait_s"] < 0.25 + 5.0
    assert 0.05 <= root.args["run_s"] < root.dur_s
    assert root.args["timed_out"] is False
    assert root.args["wait_s"] + root.args["run_s"] <= root.dur_s
    for th in App.clock.threads:
        th.join(5.0)
        assert not th.is_alive()


def _pipeline(batch_size: int, **kw):
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.herder.admission import AdmissionPipeline
    from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.testutils import build_tx, native_payment_op
    from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock
    from stellar_core_tpu_torch import xdr as X
    lm = LedgerManager(sha256(b"tracing window admission"))
    lm.start_new_ledger()
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    pipe = AdmissionPipeline(TransactionQueue(lm), lm, clock,
                             batch_size=batch_size, **kw)
    frames = []
    for i in range(8):
        sk = SecretKey(sha256(b"tracing window sender %d" % i))
        frames.append(build_tx(lm.network_id, sk, 1, [native_payment_op(
            X.AccountID.ed25519(sk.public_key.ed25519), 1)]))
    return pipe, clock, frames


def test_size_and_deadline_flushes_move_their_own_counters():
    names = [f"herder.admission.flush-{r}" for r in ("size", "deadline",
                                                     "drain")]
    pipe, clock, frames = _pipeline(batch_size=2)
    before = [counter(n) for n in names]
    collects = timer_count("herder.admission.collect")

    def moved():
        return [counter(n) - b for n, b in zip(names, before)]

    pipe.submit(frames[0])            # idle: the synchronous path
    pipe.submit(frames[1])            # a burst: pending, deadline armed
    assert moved() == [0, 0, 0]
    pipe.submit(frames[2])            # two signatures pending: size
    assert moved() == [1, 0, 0]
    pipe.submit(frames[3])            # pending again, deadline armed
    clock.crank_for(1.0)
    assert moved() == [1, 1, 0]
    pipe.submit(frames[4])            # idle again: synchronous
    pipe.submit(frames[5])            # a burst: pending, deadline armed
    pipe._flush_timer.cancel()
    pipe.drain()
    assert moved() == [1, 1, 1]
    assert pipe.depth == 0
    # one collect action a batch, none of them on the card
    assert timer_count("herder.admission.collect") - collects == 3
    assert pipe.stats["batches"] == 3


def test_a_card_batch_times_its_device_wait():
    """On the plain versions the pipeline's batch goes through the
    device path: its collect's wait is herder.admission.device-wait, a
    child span of herder.admission.collect."""
    pipe, clock, frames = _pipeline(batch_size=2, accel=True,
                                    accel_device="cpu", accel_min_sigs=1)
    try:
        deadline = time.monotonic() + 120.0
        while not pipe._preverify.job_done(pipe._warm_id):
            assert time.monotonic() < deadline, "warm batch not done"
            time.sleep(0.01)
        waits = timer_count("herder.admission.device-wait")
        t0 = time.time_ns()
        pipe.submit(frames[0])
        pipe.submit(frames[1])
        pipe.submit(frames[2])        # size flush, dispatched
        assert pipe.stats["sigs_offloaded"] == 2
        pipe.drain()
        assert timer_count("herder.admission.device-wait") == waits + 1
        [(a, b, _)] = tracing.spans_between(t0, 2 ** 63,
                                            "herder.admission.device-wait")
        [(c, d, _)] = tracing.spans_between(t0, 2 ** 63,
                                            "herder.admission.collect")
        assert c <= a < b <= d
    finally:
        pipe.close()


def test_verify_prep_span_on_the_plain_versions():
    from stellar_core_tpu_torch.accel.ed25519 import verify_batch_async
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.crypto.sha import sha256
    pks, sigs, msgs = [], [], []
    for i in range(3):
        sk = SecretKey(sha256(b"prep key %d" % i))
        msg = b"prep message %d" % i
        pks.append(sk.public_key.ed25519)
        sigs.append(sk.sign(msg))
        msgs.append(msg)
    sigs.append(b"\x00" * 64)         # rejected in the prep
    pks.append(pks[0])
    msgs.append(b"x")
    before = timer_count("accel.ed25519.prep")
    collect = verify_batch_async(pks, sigs, msgs, device="cpu")
    # (a device thread of an earlier test may still be verifying)
    [(a, b, args)] = [
        (a, b, args) for a, b, args in
        tracing.spans_between(0, 2 ** 63, "accel.ed25519.prep")
        if args["n"] == 4]
    assert (args["hot"], args["cold"]) == (0, 3)
    assert 0.0 < args["cpu_s"] <= (b - a) / 1e9 + 1e-3
    assert timer_count("accel.ed25519.prep") >= before + 1
    assert list(collect()) == [True, True, True, False]


def test_a_cpu_timed_span_times_its_thread_cpu_not_its_waits(monkeypatch):
    """cpu=True: the timer takes the thread's CPU seconds inside the span
    (a thread waiting for the GIL, or asleep, spends none); the span keeps
    its wall seconds and the CPU seconds as `cpu_s`."""
    monkeypatch.setattr(metrics, "_registry", metrics.MetricsRegistry())
    with tracing.timed_span("accel.ed25519.prep", cpu=True, n=1) as s:
        time.sleep(0.2)
    t = metrics.registry().timer("accel.ed25519.prep")
    assert t.count == 1 and t.total == s.args["cpu_s"]
    assert 0.0 <= s.args["cpu_s"] < 0.1 and s.dur_s >= 0.2
    with tracing.timed_span("accel.ed25519.prep") as w:
        time.sleep(0.05)
    assert t.count == 2 and t.total == s.args["cpu_s"] + w.dur_s
    assert w.args is None


def test_a_forced_collection_moves_the_gc_pause_timer():
    assert tracing._gc_pause in gc.callbacks
    t = metrics.registry().timer(tracing.GC_PAUSE_TIMER)
    before, total = t.count, t.total
    gc.collect()
    gc.collect()
    assert t.count >= before + 2
    assert t.total > total


def test_the_gc_pause_timer_follows_a_registry_reset(monkeypatch):
    monkeypatch.setattr(metrics, "_registry", metrics.registry())
    metrics.reset_registry()
    assert metrics.registry().names() == [tracing.GC_PAUSE_TIMER]
    gc.collect()
    assert metrics.registry().timer(tracing.GC_PAUSE_TIMER).count >= 1


def test_a_collection_makes_no_metric(monkeypatch):
    """The gc callback only looks its timer up: it may run in the middle
    of another thread's walk of the registry, which an insert would
    break.  A registry made without the timer gets none."""
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_registry", reg)
    gc.collect()
    assert reg.names() == []


def test_catchup_minimal_records_the_bucket_apply(tmp_path):
    from stellar_core_tpu_torch.catchup.catchup import CatchupManager
    from stellar_core_tpu_torch.history.archive import FileHistoryArchive
    from stellar_core_tpu_torch.history.manager import HistoryManager
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.simulation import LoadGenerator
    from stellar_core_tpu_torch.testutils import network_id
    nid = network_id("tracing window net")
    mgr = LedgerManager(nid)
    mgr.start_new_ledger()
    archive = FileHistoryArchive(str(tmp_path / "archive"))
    gen = LoadGenerator(mgr, HistoryManager(mgr, "tracing window net",
                                            [archive]), seed=5)
    gen.create_accounts(4, per_ledger=4)
    gen.run_to_checkpoint_boundary()
    before = timer_count("catchup.bucket-apply")
    got = CatchupManager(nid, "tracing window net",
                         accel=False).catchup_minimal(archive)
    assert got.lcl_hash == mgr.lcl_hash
    assert timer_count("catchup.bucket-apply") == before + 1
    [root] = [r for r in tracing.trace_buffer().roots()
              if r.name == "catchup.bucket-apply"]
    assert root.parent is None and root.tid == threading.get_ident()


@pytest.mark.parametrize("profile", ["poll", "race"])
def test_each_preverify_collect_is_a_span(profile):
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    pipe, _, frames = _pipeline(batch_size=2)
    pv = PreverifyPipeline(pipe.lm.network_id, profile=profile,
                           device="cpu")
    try:
        t0 = time.time_ns()
        pv.dispatch({5: frames[:2]})
        deadline = time.monotonic() + 120.0
        while not pv.job_done(5):
            assert time.monotonic() < deadline, "group not done"
            time.sleep(0.01)
        pv.collect(5, last=True)
        pv.collect(6)                 # never dispatched
        got = [args for _, _, args in
               tracing.spans_between(t0, 2 ** 63, "catchup.preverify.collect")
               if args["checkpoint"] in (5, 6)]
        assert [(a["checkpoint"], a["ripe"]) for a in got] \
            == [(5, True), (6, None)]
    finally:
        pv.close()
