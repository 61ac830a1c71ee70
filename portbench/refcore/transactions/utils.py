"""Transaction-layer ledger helpers.

Reference: src/transactions/TransactionUtils.{h,cpp} — loadAccount/
loadTrustLine accessors, addBalance, getAvailableBalance, minimum-balance
(reserve) logic; src/ledger/LedgerTxnHeader reserve math.
Protocol level: current (23) semantics; earlier version gates are collapsed
and documented where behavior differs.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import xdr as X
from ..ledger.ledger_txn import LedgerTxn

INT64_MAX = 2 ** 63 - 1

# thresholds indices into AccountEntry.thresholds
THRESHOLD_MASTER_WEIGHT = 0
THRESHOLD_LOW = 1
THRESHOLD_MED = 2
def account_key(account_id: X.AccountID) -> X.LedgerKey:
    return X.LedgerKey.account(X.LedgerKeyAccount(accountID=account_id))


def load_account(ltx: LedgerTxn, account_id: X.AccountID) -> Optional[X.LedgerEntry]:
    return ltx.load_by_bytes(X.account_key_xdr(account_id.value))


def num_sponsoring(acc: X.AccountEntry) -> int:
    v2 = _acc_ext_v2(acc)
    return v2.numSponsoring if v2 else 0


def num_sponsored(acc: X.AccountEntry) -> int:
    v2 = _acc_ext_v2(acc)
    return v2.numSponsored if v2 else 0


def _acc_ext_v1(acc: X.AccountEntry) -> Optional[X.AccountEntryExtensionV1]:
    return acc.ext.value if acc.ext.switch == 1 else None


def _acc_ext_v2(acc: X.AccountEntry):
    v1 = _acc_ext_v1(acc)
    if v1 is not None and v1.ext.switch == 2:
        return v1.ext.value
    return None


def account_liabilities(acc: X.AccountEntry) -> Tuple[int, int]:
    """(buying, selling)."""
    v1 = _acc_ext_v1(acc)
    if v1 is None:
        return 0, 0
    return v1.liabilities.buying, v1.liabilities.selling


def minimum_balance(header: X.LedgerHeader, acc: X.AccountEntry) -> int:
    """(2 + numSubEntries + numSponsoring - numSponsored) * baseReserve
    (reference: getMinBalance, protocol >= 14 sponsorship form)."""
    count = 2 + acc.numSubEntries + num_sponsoring(acc) - num_sponsored(acc)
    return count * header.baseReserve


def add_balance(acc: X.AccountEntry, delta: int,
                header: Optional[X.LedgerHeader] = None) -> bool:
    """In-place native balance adjustment with reserve/liability floors and
    int64 ceiling (reference: addBalance + addBalanceSkipAuthorization)."""
    new = acc.balance + delta
    if new < 0 or new > INT64_MAX:
        return False
    if delta < 0:
        floor = 0
        if header is not None:
            _, selling = account_liabilities(acc)
            floor = minimum_balance(header, acc) + selling
        if new < floor:
            return False
    else:
        buying, _ = account_liabilities(acc)
        if new > INT64_MAX - buying:
            return False
    acc.balance = new
    return True


def threshold_level_value(acc: X.AccountEntry, level: int) -> int:
    return acc.thresholds[level]


