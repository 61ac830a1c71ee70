"""The reference's own live-node tests, run on both packages and compared.

Each case of tests/test_scp.py, test_tx_queue.py, test_admission.py and
test_quorum_intersection.py runs on ``stellar_core_tpu`` and again,
compiled against it, on ``stellar_core_tpu_torch`` (test_torch_mirror.py):
the outcomes must be equal and every ledger close the same hash and result
set, byte for byte.  The port's preverify pipeline, which the admission
pipeline's accel path runs on, is pinned to the plain versions on the CPU
(``PreverifyPipeline.DEFAULT_DEVICE = "cpu"``), on one torch thread.

The overlay, main.status and simulation.simulation are ported now, so
test_admission.py's back-pressure valve into overlay flow control, its
/health degradation and its overlay soak run too (test_herder_simulation.py
is mirrored in test_torch_node_mirror.py).  No case is left out.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_mirror import assert_mirrored, cases

FILES = ("test_scp.py", "test_tx_queue.py", "test_admission.py",
         "test_quorum_intersection.py")
# the cases cases() leaves out, each for a module the port lacks: none
# since the overlay was ported
AWAITING_OVERLAY = set()
# the three that waited for it
OVERLAY_CASES = {
    ("test_admission.py",
     "TestBackpressureValve.test_peer_grants_deferred_while_backpressured"),
    ("test_admission.py",
     "TestBackpressureValve.test_health_degrades_on_sustained_backlog"),
    ("test_admission.py",
     "TestOverlayAdmissionSoak."
     "test_loopback_floods_drive_hysteresis_valve_under_sanitizer"),
}


@pytest.fixture(autouse=True)
def plain_versions_on_one_thread(monkeypatch):
    from stellar_core_tpu_torch.catchup.catchup import PreverifyPipeline
    monkeypatch.setattr(PreverifyPipeline, "DEFAULT_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("filename, case", [
    (f, c) for f in FILES for c in cases(f)])
def test_reference_live_node_tests_on_both_packages(filename, case):
    assert_mirrored(filename, case)


def test_every_case_runs_but_those_awaiting_the_overlay():
    """cases() keeps every test of the four files that is not marked
    slow, the three that needed the overlay or main.status among them."""
    import ast
    from test_torch_mirror import TESTS, _marks
    for f in FILES:
        tree = ast.parse((TESTS / f).read_text())
        every = []
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name.startswith("test_") \
                    and "slow" not in _marks(node):
                every.append(node.name)
            elif isinstance(node, ast.ClassDef) \
                    and node.name.startswith("Test"):
                every += [f"{node.name}.{fn.name}" for fn in node.body
                          if isinstance(fn, ast.FunctionDef)
                          and fn.name.startswith("test_")
                          and "slow" not in _marks(fn)]
        left_out = {(f, c) for c in every} - {(f, c) for c in cases(f)}
        assert left_out == {k for k in AWAITING_OVERLAY if k[0] == f}, f
        assert {k for k in OVERLAY_CASES if k[0] == f} \
            <= {(f, c) for c in cases(f)}
