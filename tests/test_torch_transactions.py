"""The port's transactions layer against the reference's.

Every test of tests/test_tx_apply.py, test_offer_exchange.py,
test_sponsorship.py, test_protocol_versions.py and test_property.py (its
property checks of the offer exchange, the XDR decoders and strkeys, on
draws of hypothesis) that the port can run (test_torch_mirror.cases)
runs on both packages with the same seeded keys: the reference's own
checks must pass on both, and every ledger close must give the same hash
and the same TransactionResultSet bytes.  These cover bad auth, extra signatures, failed transactions
consuming their sequence number, fee bumps, offers crossing, path
payments, liquidity pools, sponsorship sandwiches and revokes, and the
protocol-version gates.
"""

import pytest

from test_torch_mirror import assert_mirrored, cases

FILES = ("test_tx_apply.py", "test_offer_exchange.py", "test_sponsorship.py",
         "test_protocol_versions.py", "test_property.py")


@pytest.mark.parametrize("filename, case", [
    (f, c) for f in FILES for c in cases(f)])
def test_reference_scenario_on_both_packages(filename, case):
    assert_mirrored(filename, case)
