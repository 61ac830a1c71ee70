"""The port's work tree (stellar_core_tpu_torch/work/work.py) frees what it
held once it has finished: no finished work is part of a reference cycle,
so a finished tree, and a finished catchup's whole ledger state with it,
goes at its last reference, not at a full pass of the cyclic collector.
A child still wakes its parent across retries, restarts and shutdown.
tests/test_work.py holds the framework's behaviour in the reference."""

import gc
import weakref

import pytest

from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock
from stellar_core_tpu_torch.work import (BasicWork, BatchWork,
                                         ConditionalWork, State, Work,
                                         WorkScheduler, WorkSequence)


@pytest.fixture
def no_collector():
    """The cyclic collector off for the test's body: what it frees was
    freed by reference counts."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def make_sched():
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    return clock, WorkScheduler(clock)


class CountedWork(BasicWork):
    """Succeeds after `steps` cranks; fails its first `fail_times` runs."""

    def __init__(self, clock, name="counted", steps=2, fail_times=0,
                 max_retries=5):
        super().__init__(clock, name, max_retries)
        self.steps, self.fail_times, self.runs = steps, fail_times, 0

    def on_reset(self):
        self.runs = 0

    def on_run(self):
        self.runs += 1
        if self.runs < self.steps:
            return State.RUNNING
        if self.fail_times > 0:
            self.fail_times -= 1
            return State.FAILURE
        return State.SUCCESS


class Parent(Work):
    """Adds two children at every (re)start."""

    def __init__(self, clock, fail_times=0, child_fail_times=0):
        super().__init__(clock, "parent")
        self.fail_times, self.child_fail_times = fail_times, child_fail_times

    def do_reset(self):
        for i in range(2):
            self.add_work(CountedWork(self.clock, f"kid{i}",
                                      fail_times=self.child_fail_times))

    def do_work(self):
        if self.fail_times > 0:
            self.fail_times -= 1
            return State.FAILURE
        return State.SUCCESS


def tree(kind, clock):
    if kind == "work":
        return Parent(clock)
    if kind == "sequence":
        return WorkSequence(clock, "seq", [CountedWork(clock, f"s{i}")
                                           for i in range(2)])
    if kind == "batch":
        return BatchWork(clock, "batch", iter([CountedWork(clock, f"b{i}")
                                               for i in range(3)]),
                         max_concurrency=2)
    return ConditionalWork(clock, "cond", lambda: True,
                           CountedWork(clock, "wrapped"))


@pytest.mark.parametrize("kind", ["work", "sequence", "batch",
                                  "conditional"])
def test_a_finished_tree_is_freed_without_the_collector(no_collector, kind):
    clock, sched = make_sched()
    root = tree(kind, clock)
    assert sched.execute(root)
    assert sched.children == []
    ref = weakref.ref(root)
    del root
    assert ref() is None


def test_a_retried_child_still_wakes_its_parent(no_collector):
    clock, sched = make_sched()
    p = Parent(clock, child_fail_times=2)
    assert sched.execute(p)
    kids = list(p.children)
    assert [k.state for k in kids] == [State.SUCCESS] * 2
    assert all(k.retries == 2 for k in kids)
    ref = weakref.ref(p)
    del p, kids
    assert ref() is None


def test_a_restarted_child_gets_its_callback_back(no_collector):
    """The parent fails its own step once: its retry starts two new
    children, which must wake it again."""
    clock, sched = make_sched()
    p = Parent(clock, fail_times=1)
    assert sched.execute(p)
    assert p.retries == 1 and p.succeeded
    ref = weakref.ref(p)
    del p
    assert ref() is None


class Idle(BasicWork):
    """Waits for a wake-up that never comes."""

    def on_run(self):
        return State.WAITING


def test_a_child_shut_down_still_wakes_its_parent():
    clock, sched = make_sched()
    p = Work(clock, "parent", max_retries=0)
    sched.schedule(p)
    kid = p.add_work(Idle(clock, "kid"))
    while clock.crank(block=False):
        pass
    assert p.state == State.WAITING and kid.state == State.WAITING
    kid.shutdown()
    clock.crank_until(lambda: p.done, 10)
    assert kid.state == State.ABORTED and p.state == State.FAILURE


# -- a catchup's work tree ----------------------------------------------------

NET = "torch work net"


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """(archive dir, the replay's last ledger, its hash): a checkpoint of
    accounts, then four ledgers of payments published at the next one."""
    from stellar_core_tpu_torch.history.archive import FileHistoryArchive
    from stellar_core_tpu_torch.history.manager import HistoryManager
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.simulation import LoadGenerator
    from stellar_core_tpu_torch.testutils import network_id
    path = str(tmp_path_factory.mktemp("work-archive"))
    mgr = LedgerManager(network_id(NET))
    mgr.start_new_ledger()
    gen = LoadGenerator(mgr, HistoryManager(mgr, NET,
                                            [FileHistoryArchive(path)]),
                        seed=17)
    gen.create_accounts(24, per_ledger=12)
    gen.run_to_checkpoint_boundary()
    gen.payment_ledgers(4, txs_per_ledger=6)
    last, last_hash = mgr.last_closed_ledger_seq, mgr.lcl_hash
    gen.run_to_checkpoint_boundary()
    return path, last, last_hash


def catchup_recent(published):
    """One pass as `catchup <last>/4` makes it, on the Python close (the
    card's machine has no libsodium for the native one); returns the
    tip's hash."""
    from stellar_core_tpu_torch.catchup.catchup import CatchupManager
    from stellar_core_tpu_torch.history.archive import FileHistoryArchive
    from stellar_core_tpu_torch.testutils import network_id
    path, last, _ = published
    cm = CatchupManager(network_id(NET), NET, accel=False, native=False)
    return cm.catchup_recent(FileHistoryArchive(path), 4,
                             to_ledger=last).lcl_hash


def test_a_finished_catchup_leaves_no_cyclic_garbage(published):
    assert catchup_recent(published) == published[2]   # imports, caches
    gc.collect()
    gc.disable()
    try:
        assert catchup_recent(published) == published[2]
        first = len(gc.get_objects())
        assert catchup_recent(published) == published[2]
        second = len(gc.get_objects())
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        port = [type(o).__qualname__ for o in gc.garbage
                if (type(o).__module__ or "").startswith(
                    "stellar_core_tpu_torch")]
    finally:
        gc.set_debug(0)
        del gc.garbage[:]
        gc.enable()
    assert port == []
    # a pass whose tree kept its cycle left its state behind, about 2,400
    # objects at this size; a pass may keep only what its trace spans and
    # the process's bounded caches add (tens)
    assert abs(second - first) < 500, (first, second)
