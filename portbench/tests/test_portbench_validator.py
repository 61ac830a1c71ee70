"""The validator cells at a tiny size on the CPU (1 s ledgers): a sound run
is correct, and each fault the cells can have makes it not correct."""

import pytest

from portbench.runners import validator
from portbench.lib import faults

from . import tiny


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    # the plain K-G takes about 0.5 s a batch on the CPU: give admission's
    # race the time, as the port's own CPU tests do
    monkeypatch.setattr(PreverifyPipeline, "RACE_CPU_S_PER_SIG", 10.0)


def _run(tmp_path, workload, fault=None, **mix):
    c = validator.Cell(tiny.cell(workload, mix=mix), 2 ** 31 + 7, 4.0, False,
                       device="cpu", workdir=tmp_path / "node")
    c.setup()
    if fault is None:
        w = c.run()
    else:
        with faults.plant(fault):
            w = c.run()
    c.release()
    return w, c.check()


# the generator's bursts (after each close, posted with no pacing) are a
# mix's data: a burst mix at the tiny size rides on tx-steady's cell
@pytest.mark.parametrize("mix", [{}, {"rate_tx_s": 4, "burst_size": 20}],
                         ids=["tx-steady", "tx-steady-bursts"])
def test_sound_run_is_correct(tmp_path, mix):
    w, v = _run(tmp_path, "tx-steady", **mix)
    assert v["correct"], v
    e2e = w["end_to_end"]
    assert e2e["tx_confirm_p95_s"] > 0 and e2e["tx_reply_p95_ms"] > 0
    assert w["stats"]["admission_submitted"] > 0


@pytest.mark.parametrize("fault", ["control", "state_unchanged"])
def test_fault_is_caught(tmp_path, fault):
    _, v = _run(tmp_path, "tx-steady", fault)
    assert not v["correct"], v
