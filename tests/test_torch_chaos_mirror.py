"""The reference's own chaos-campaign tests, run on both packages and
compared.

Each case of tests/test_chaos.py runs on ``stellar_core_tpu`` and again,
compiled against it, on ``stellar_core_tpu_torch`` (test_torch_mirror.py):
the outcomes must be equal and every ledger close of every simulated node
the same hash and result set, byte for byte, in the same order.  The
campaigns run on ``Simulation``'s virtual clock and seeded fault RNGs, so
both packages close the same ledgers.  Their nodes verify on the CPU (the
catalogue gives ``Simulation`` no accel settings), on one torch thread.

No case is left out: every test of the file not marked slow runs
(TestSoaks is marked slow, as for the reference).  This file is apart from
test_torch_fleet_mirror.py so that a distributed run puts the two slowest
mirrors on different workers.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_fleet_mirror import every_case
from test_torch_mirror import assert_mirrored, cases

FILE = "test_chaos.py"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", cases(FILE))
def test_reference_chaos_tests_on_both_packages(case):
    assert_mirrored(FILE, case)


def test_every_case_runs():
    """cases() keeps every test of the file that is not marked slow."""
    assert sorted(cases(FILE)) == sorted(every_case(FILE))
