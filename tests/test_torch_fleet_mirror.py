"""The reference's own fleet, fleet-observability and utility tests, run
on both packages and compared.

Each case of tests/test_fleet.py, test_fleettrace.py and
test_util_extras.py runs on ``stellar_core_tpu`` and again, compiled
against it, on ``stellar_core_tpu_torch`` (test_torch_mirror.py): the
outcomes must be equal and every ledger close in this process the same
hash and result set, byte for byte.  The reference's nodes run with its
default ACCEL, "none"; the port's default is the card, so its nodes are
given "none" too (``STPU_ACCEL``, which the fleet's `run` and `catchup
--parallel` subprocesses inherit).

WALL_CLOCK: the fleet's end-to-end case runs five `run` processes over
real TCP on the wall clock, so it is compared by outcome: its ledgers
close in the node processes, on close times that are the seconds the run
took, and none closes in this one.  Its report's own checks (every SLO,
no hash divergence between the nodes, the rejoin's parallel catchup, the
merged trace) are the case's assertions, on both packages.

SIGNALLED: three of test_util_extras.py's ProcessManager cases signal a
``python3 -c`` child after sleeping 0.3 s "to let the child install its
handler".  A loaded machine can start the child later than that, and it
then dies of SIGTERM's default action, on either package.  In their
mirror, ProcessManager.stop and .shutdown of both packages first wait
until each running child has set its SIGTERM disposition (caught or
ignored, as /proc/<pid>/status gives it), which is what the sleep is
for; every assertion of the cases stands as it is.

No case is left out: every test of the three files not marked slow runs
(TestFleetSoak is marked slow, as for the reference).
"""

from __future__ import annotations

import ast
import importlib
import signal
import time

import pytest
import torch

from test_torch_mirror import (PORT, REF, TESTS, _marks, assert_mirrored,
                               cases, run_case)

FILES = ("test_fleet.py", "test_fleettrace.py", "test_util_extras.py")
WALL_CLOCK = {
    ("test_fleet.py",
     "TestFleetEndToEnd."
     "test_five_nodes_kill_rejoin_partition_roll_no_divergence"),
}
SIGNALLED = {("test_util_extras.py", f"TestProcessManager.{c}") for c in (
    "test_stop_graceful_child_exits_zero",
    "test_stop_escalates_sigkill_on_signal_ignoring_child",
    "test_shutdown_with_grace_terms_then_kills")}
HANDLER_WAIT_S = 120.0


@pytest.fixture(autouse=True)
def accel_off_on_one_thread(monkeypatch):
    monkeypatch.setenv("STPU_ACCEL", "none")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_outcomes(filename: str, case: str) -> None:
    """The reference passes the case and the port's outcomes equal it;
    no ledger closed in this process on either."""
    ref = run_case(filename, case, REF)
    assert all(o[0] != "fail" for o in ref["outcomes"]), ref["outcomes"]
    port = run_case(filename, case, PORT)
    assert port["outcomes"] == ref["outcomes"]
    assert ref["closes"] == port["closes"] == []


def sigterm_set(pid: int) -> bool:
    """Whether process `pid` catches or ignores SIGTERM (True once it is
    gone)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            masks = [line.split(":", 1)[1] for line in f
                     if line.startswith(("SigCgt:", "SigIgn:"))]
    except OSError:
        return True
    return any(int(m, 16) >> (signal.SIGTERM - 1) & 1 for m in masks)


def handlers_before_signals(monkeypatch) -> None:
    """ProcessManager.stop and .shutdown of both packages, each waiting
    first (up to HANDLER_WAIT_S) until every running child has set its
    SIGTERM disposition."""
    def await_handlers(pm):
        deadline = time.monotonic() + HANDLER_WAIT_S
        for ev in list(pm._running):
            while ev.proc is not None and ev.proc.poll() is None \
                    and not sigterm_set(ev.proc.pid) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)

    for root in (REF, PORT):
        cls = importlib.import_module(f"{root}.util.process").ProcessManager
        for name in ("stop", "shutdown"):
            def wrapped(self, *args, _real=getattr(cls, name), **kw):
                await_handlers(self)
                return _real(self, *args, **kw)

            monkeypatch.setattr(cls, name, wrapped)


@pytest.mark.parametrize("filename, case", [
    (f, c) for f in FILES for c in cases(f)])
def test_reference_fleet_tests_on_both_packages(filename, case,
                                                monkeypatch):
    if (filename, case) in SIGNALLED:
        handlers_before_signals(monkeypatch)
    if (filename, case) in WALL_CLOCK:
        assert_same_outcomes(filename, case)
    else:
        assert_mirrored(filename, case)


def every_case(filename: str) -> list:
    """Every test of tests/`filename` not marked slow."""
    tree = ast.parse((TESTS / filename).read_text())
    every = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name.startswith("test_") and "slow" not in _marks(n)]
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test") \
                and "slow" not in _marks(node):
            every += [f"{node.name}.{fn.name}" for fn in node.body
                      if isinstance(fn, ast.FunctionDef)
                      and fn.name.startswith("test_")
                      and "slow" not in _marks(fn)]
    return every


def test_every_case_runs():
    """cases() keeps every test of the three files that is not marked
    slow; the wall-clock and the signalled cases are among them."""
    for f in FILES:
        assert sorted(cases(f)) == sorted(every_case(f)), f
    for f, c in WALL_CLOCK | SIGNALLED:
        assert c in cases(f), (f, c)
