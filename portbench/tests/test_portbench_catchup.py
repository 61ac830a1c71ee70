"""The catchup cell at a tiny size on the CPU: a sound run is correct, and
each fault the cell can have makes it not correct."""

import pytest

from portbench.runners import catchup
from portbench.lib import faults

from . import tiny


@pytest.fixture(autouse=True)
def _python_close(monkeypatch):
    # the card's machine has no libsodium, so the port's replay closes on
    # its Python path there; hold this machine to the same path
    monkeypatch.setenv("STELLAR_TPU_NO_CAPPLY", "1")
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    monkeypatch.setattr(PreverifyPipeline, "DEFAULT_DEVICE", "cpu")


def _run(tmp_path, fault=None, seconds=25.0):
    # one checkpoint: the replay's last group waits for the plain K-G, so
    # every verdict the window uses is the card path's, and a fault planted
    # there shows (under `poll` a late group's verdicts are not used)
    c = catchup.Cell(tiny.cell("catchup-pubnet"), 2 ** 31 + 99, seconds,
                     False, device="cpu", workdir=tmp_path / "work")
    c.setup()
    if fault is None:
        w = c.run()
    else:
        with faults.plant(fault):
            w = c.run()
    c.release()
    return w, c.check()


def test_sound_run_is_correct(tmp_path):
    w, v = _run(tmp_path)
    assert v["correct"], v
    assert v["attempted"] >= 1
    assert w["end_to_end"]["replay_ledgers_per_s"] > 0
    reg = w["registry"]
    assert reg["catchup.preverify.sigs-total"] > 0
    assert reg["ledger.ledger.close"][0] == v["attempted"]


@pytest.mark.parametrize("fault", ["control", "answer_altered",
                                   "half_left_out", "state_unchanged"])
def test_fault_is_caught(tmp_path, fault):
    _, v = _run(tmp_path, fault)
    assert not v["correct"], v
