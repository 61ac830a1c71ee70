"""The catchup cell at a tiny size on the CPU, on both of the port's apply
paths (its Python close, and the native engine where it loads): a 5 s
window of whole passes closes, a sound run is correct, and each fault the
cell can have makes it not correct."""

import contextlib
import time

import numpy as np
import pytest

from portbench.lib import faults, harness
from portbench.runners import catchup

from . import tiny

PATHS = [pytest.param(False, id="python"), pytest.param(True, id="native")]


@pytest.fixture(autouse=True)
def _plain_kg(monkeypatch):
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    monkeypatch.setattr(PreverifyPipeline, "DEFAULT_DEVICE", "cpu")


def _run(tmp_path, native, fault=None, seconds=5.0):
    # one checkpoint: the replay's last group waits for the plain K-G, so
    # every verdict the window uses is the card path's, and a fault planted
    # there shows (under `poll` a late group's verdicts are not used)
    tiny.engine_or_skip(native)
    c = catchup.Cell(tiny.cell("catchup-pubnet",
                               catchup={"native": native}),
                     2 ** 31 + 99, seconds, False, device="cpu",
                     workdir=tmp_path / "work")
    c.setup()
    with faults.plant(fault) if fault else contextlib.nullcontext():
        w = tiny.within(c.run)
    c.release()
    return c, w, c.check()


@pytest.mark.parametrize("native", PATHS)
def test_sound_window_of_whole_passes_is_correct(tmp_path, native):
    c, w, v = _run(tmp_path, native)
    assert v["correct"], v
    assert all(value == 0 for _, value, _ in v["checks"]), v["checks"]
    st = w["stats"]
    assert st["window_s"] >= 5.0
    assert st["passes"] >= 1
    assert st["ledgers_in_window"] == st["passes"] * (c.last - c.first + 1)
    assert st["ledgers_in_window"] == v["attempted"]
    assert w["end_to_end"]["replay_ledgers_per_s"] > 0
    reg = w["registry"]
    assert reg["catchup.preverify.sigs-total"] > 0
    if native:
        assert st["native_checkpoints"] == st["passes"]
        assert reg.get("ledger.ledger.close", (0, 0.0))[0] == 0
        assert st["native_verify_cache_hits"] > 0
    else:
        assert st["native_checkpoints"] == 0
        assert reg["ledger.ledger.close"][0] == v["attempted"]
    ctx = harness.Context(reg, None, st)
    apply_ms = harness.metric_reader(
        "catchup.apply_ms_per_ledger.catchup")(ctx)
    assert apply_ms is not None and apply_ms > 0
    assert harness.metric_reader("catchup.cpu_verify_pct")(ctx) == 0
    _comparison_reads_each_pass(c)


def _comparison_reads_each_pass(c):
    """Each check reads what a pass returned: a wrong hash, an account
    whose balance or sequence number differs, a pass that stopped short."""
    sound = list(c.results)
    seq, lcl_hash, bal, seqs = sound[0]
    for altered, check in (
            ((seq, bytes(32), bal, seqs), "ledger_hash_mismatches"),
            ((seq, lcl_hash, bal + (np.arange(len(bal)) == 3), seqs),
             "tx_result_mismatches"),
            ((seq, lcl_hash, bal, seqs - (np.arange(len(bal)) == 5)),
             "tx_result_mismatches"),
            ((seq - 1, c.ref["ledgers"][seq - 1]["hash"], bal, seqs),
             "passes_short_of_tip")):
        c.results = [altered] + sound[1:]
        v = dict((k, x) for k, x, _ in c.check()["checks"])
        assert v[check] == 1, (check, v)
        assert not c.check()["correct"]
    c.results = sound


@pytest.mark.parametrize("native", PATHS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(tmp_path, native, fault):
    _, _, v = _run(tmp_path, native, fault)
    assert not v["correct"], v


class _HostTrace:
    """lib.trace.DeviceTrace's interface with no device: no operation, so
    the whole window is idle and the breakdown labels all of it."""

    def __init__(self):
        self.ops = []

    def start(self):
        self.t0_ns = time.time_ns()

    def stop(self):
        self.t1_ns = time.time_ns()

    @property
    def window_s(self):
        return (self.t1_ns - self.t0_ns) / 1e9


def test_a_traced_window_keeps_its_spans_and_labels_its_gaps(
        tmp_path, monkeypatch):
    from stellar_core_tpu_torch.util import tracing
    # a buffer that this window would overflow, as a fast card host's
    # 50 s window overflows the program's own
    monkeypatch.setattr(tracing.trace_buffer(), "max_spans", 200)
    monkeypatch.setattr(catchup.tr, "DeviceTrace", _HostTrace)
    c = catchup.Cell(tiny.cell("catchup-pubnet", catchup={"native": False}),
                     2 ** 31 + 98, 3.0, True, device="cpu",
                     workdir=tmp_path / "work")
    c.setup()
    w = tiny.within(c.run)
    c.release()
    assert c.check()["correct"]
    assert w["registry"].get("tracing.spans-evicted", 0) == 0
    gaps = dict(w["breakdown"]["idle_gaps"])
    for _, label in catchup.HOST_SPANS:
        assert gaps.get(label, 0) > 0, (label, gaps)
    assert sum(gaps.values()) == pytest.approx(w["trace"].window_s)
