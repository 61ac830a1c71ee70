"""The readers of the program's own spans, timers and counters
(lib/spans.py and the nine metrics/ files that use it), on a fake window:
each reads its value, None on an empty window, and None where the
program's trace buffer evicted spans in the window."""

import time

import pytest

from portbench.lib import harness
from stellar_core_tpu_torch.util import tracing


class _Trace:
    def __init__(self, t0_ns, t1_ns):
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.ops = []


@pytest.fixture
def tx_spans():
    """Twenty http.tx spans with wait_s 0.001, 0.002, ... 0.020 s, and the
    trace window around them."""
    tracing.trace_buffer().clear()
    t0 = time.time_ns()
    for i in range(20):
        with tracing.span("http.tx"):
            tracing.annotate(wait_s=(i + 1) / 1000, run_s=0.0,
                             timed_out=False)
    with tracing.span("http.tx"):
        pass                           # not marshalled: no wait
    yield _Trace(t0, time.time_ns())
    tracing.trace_buffer().clear()


REGISTRY = {
    "herder.admission.collect": (4, 0.02),
    "herder.admission.device-wait": (2, 0.003),
    "herder.admission.flush-size": 1,
    "herder.admission.flush-deadline": 6,
    "herder.admission.flush-drain": 1,
    "accel.ed25519.prep": (3, 0.012),
    "accel.ed25519.generic-sigs": 3000,
    "accel.ed25519.table-sigs": 900,
    "accel.ed25519.rejected-prep": 100,
    "catchup.bucket-apply": (2, 3.0),
    "catchup.preverify.collect-wait": (4, 0.5),
    "process.gc-pause": (50, 0.25),
}

WANT = {
    "intake.crank_wait_p95_ms.tx": 19.0,
    "admission.collect_ms.tx": 5.0,
    "admission.device_wait_ms.tx": 1.5,
    "admission.deadline_flush_pct.tx": 75.0,
    "verify.prep_ms_per_ksig.tx": 3.0,
    "verify.prep_ms_per_ksig.catchup": 3.0,
    "catchup.bucket_apply_ms.catchup": 1500.0,
    "catchup.collect_wait_ms.catchup": 125.0,
    "host.gc_pause_pct.catchup": None,    # set from the window's length
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_its_value(name, tx_spans):
    read = harness.metric_reader(name)
    want = WANT[name]
    if want is None:
        want = 100 * 0.25 / tx_spans.window_s
    assert read(harness.Context(dict(REGISTRY), tx_spans, {})) \
        == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_none_on_an_empty_window(name):
    tracing.trace_buffer().clear()
    now = time.time_ns()
    read = harness.metric_reader(name)
    assert read(harness.Context({}, _Trace(now - 10 ** 9, now), {})) is None
    assert read(harness.Context({}, None, {})) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_none_where_spans_were_evicted(name, tx_spans):
    read = harness.metric_reader(name)
    reg = dict(REGISTRY, **{"tracing.spans-evicted": 1})
    assert read(harness.Context(reg, tx_spans, {})) is None


def test_every_new_metric_is_a_benchmark_entry():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        cell = "catchup-pubnet" if name.endswith(".catchup") else "tx-steady"
        assert entries[name]["workloads"] == [cell]
        assert name in {m["name"] for m in
                        harness.find_cell(bench, cell)["per_layer"]}


def test_window_spans_read_nothing_from_a_program_without_them(monkeypatch):
    """The parent of this change has no spans_between: the span readers
    read None there, and raise nothing."""
    from portbench.lib import spans
    monkeypatch.delattr(tracing, "spans_between")
    now = time.time_ns()
    ctx = harness.Context({}, _Trace(now - 10 ** 9, now), {})
    assert spans.window_spans(ctx, "http.tx") is None
    assert harness.metric_reader("intake.crank_wait_p95_ms.tx")(ctx) is None
