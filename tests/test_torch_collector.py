"""The cyclic collector's schedule (util/collector.py): importing the
package raises the young-generation threshold for the whole process and
keeps the older two and the collector itself; a catchup runs on that
schedule and leaves it as it found it."""

import gc
import json
import subprocess
import sys

import pytest

from stellar_core_tpu_torch.util.collector import (YOUNG_THRESHOLD,
                                                   install_schedule)


@pytest.fixture
def restore_schedule():
    was = gc.get_threshold()
    yield
    gc.set_threshold(*was)


def test_importing_the_package_installs_the_schedule():
    """A fresh interpreter: the interpreter's thresholds before the
    import, the young one raised after it, the older two and the
    collector's state untouched."""
    code = ("import gc, json; before = gc.get_threshold(); "
            "import stellar_core_tpu_torch; "
            "print(json.dumps([before, gc.get_threshold(), gc.isenabled()]))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    before, after, enabled = json.loads(out.strip().splitlines()[-1])
    assert before[0] < YOUNG_THRESHOLD
    assert after == [YOUNG_THRESHOLD, *before[1:]]
    assert enabled


@pytest.mark.parametrize("start, want", [
    ((700, 10, 10), (YOUNG_THRESHOLD, 10, 10)),
    ((YOUNG_THRESHOLD, 10, 10), (YOUNG_THRESHOLD, 10, 10)),
    ((YOUNG_THRESHOLD + 1, 5, 5), (YOUNG_THRESHOLD + 1, 5, 5)),
])
def test_install_raises_young_alone_and_keeps_a_higher_one(
        restore_schedule, start, want):
    gc.set_threshold(*start)
    install_schedule()
    assert gc.get_threshold() == want
    install_schedule()
    assert gc.get_threshold() == want


def test_this_process_runs_the_schedule():
    assert gc.get_threshold()[0] >= YOUNG_THRESHOLD
    assert gc.isenabled()


def test_a_catchup_runs_on_the_schedule_and_leaves_it(tmp_path,
                                                      monkeypatch):
    from stellar_core_tpu_torch.catchup.catchup import CatchupManager
    from stellar_core_tpu_torch.history.archive import FileHistoryArchive
    from stellar_core_tpu_torch.history.manager import HistoryManager
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.simulation import LoadGenerator
    from stellar_core_tpu_torch.testutils import network_id
    net = "torch collector net"
    mgr = LedgerManager(network_id(net))
    mgr.start_new_ledger()
    archive = FileHistoryArchive(str(tmp_path / "archive"))
    gen = LoadGenerator(mgr, HistoryManager(mgr, net, [archive]), seed=3)
    gen.create_accounts(8, per_ledger=8)
    gen.run_to_checkpoint_boundary()
    gen.payment_ledgers(2, txs_per_ledger=3)
    last, want = mgr.last_closed_ledger_seq, mgr.lcl_hash
    gen.run_to_checkpoint_boundary()

    found = gc.get_threshold()
    inside = []
    close = LedgerManager.close_ledger

    def spy(self, *a, **kw):
        inside.append(gc.get_threshold())
        return close(self, *a, **kw)

    monkeypatch.setattr(LedgerManager, "close_ledger", spy)
    got = CatchupManager(network_id(net), net, accel=False,
                         native=False).catchup_recent(
        archive, 2, to_ledger=last)
    assert got.lcl_hash == want
    assert inside == [found] * 2
    assert gc.get_threshold() == found
