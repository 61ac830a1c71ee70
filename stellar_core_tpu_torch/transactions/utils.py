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
THRESHOLD_HIGH = 3


def account_key(account_id: X.AccountID) -> X.LedgerKey:
    return X.LedgerKey.account(X.LedgerKeyAccount(accountID=account_id))


def trustline_key(account_id: X.AccountID, asset: X.TrustLineAsset) -> X.LedgerKey:
    return X.LedgerKey.trustLine(X.LedgerKeyTrustLine(accountID=account_id, asset=asset))


def data_key(account_id: X.AccountID, name: bytes) -> X.LedgerKey:
    return X.LedgerKey.data(X.LedgerKeyData(accountID=account_id, dataName=name))


def cb_key(balance_id: X.ClaimableBalanceID) -> X.LedgerKey:
    return X.LedgerKey.claimableBalance(X.LedgerKeyClaimableBalance(balanceID=balance_id))


def asset_to_trustline_asset(asset: X.Asset) -> X.TrustLineAsset:
    return X.TrustLineAsset(asset.switch, asset.value)


def load_account(ltx: LedgerTxn, account_id: X.AccountID) -> Optional[X.LedgerEntry]:
    return ltx.load_by_bytes(X.account_key_xdr(account_id.value))


def load_trustline(ltx: LedgerTxn, account_id: X.AccountID,
                   asset: X.Asset) -> Optional[X.LedgerEntry]:
    return ltx.load(trustline_key(account_id, asset_to_trustline_asset(asset)))


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


def _ensure_acc_ext_v2(acc: X.AccountEntry) -> X.AccountEntryExtensionV2:
    """Materialize the v1+v2 extension chain (reference: prepareAccountEntry
    extension upgrade on first sponsorship use).  signerSponsoringIDs is
    padded to the signer count on materialization so the invariant
    len(signerSponsoringIDs) == len(signers) holds from the first
    sponsorship touch (reference: AccountEntry extension constraints)."""
    if acc.ext.switch == 0:
        acc.ext = X.AccountEntryExt.v1(X.AccountEntryExtensionV1(
            liabilities=X.Liabilities(buying=0, selling=0)))
    v1 = acc.ext.value
    if v1.ext.switch != 2:
        v1.ext = X.AccountEntryExtensionV1Ext.v2(X.AccountEntryExtensionV2(
            signerSponsoringIDs=[None] * len(acc.signers)))
    return v1.ext.value


def add_num_sponsoring(header: X.LedgerHeader, acc: X.AccountEntry,
                       delta: int) -> bool:
    """Adjust numSponsoring with a reserve check on increase (reference:
    createSponsoredEntry path — the sponsor's balance must cover the
    enlarged minimum balance)."""
    current = num_sponsoring(acc)
    new_count = current + delta
    if new_count < 0:
        return False
    if delta > 0:
        need = (2 + acc.numSubEntries + new_count - num_sponsored(acc)) \
            * header.baseReserve
        _, selling = account_liabilities(acc)
        if acc.balance < need + selling:
            return False
    _ensure_acc_ext_v2(acc).numSponsoring = new_count
    return True


def account_liabilities(acc: X.AccountEntry) -> Tuple[int, int]:
    """(buying, selling)."""
    v1 = _acc_ext_v1(acc)
    if v1 is None:
        return 0, 0
    return v1.liabilities.buying, v1.liabilities.selling


def trustline_liabilities(tl: X.TrustLineEntry) -> Tuple[int, int]:
    if tl.ext.switch != 1:
        return 0, 0
    li = tl.ext.value.liabilities
    return li.buying, li.selling


def minimum_balance(header: X.LedgerHeader, acc: X.AccountEntry) -> int:
    """(2 + numSubEntries + numSponsoring - numSponsored) * baseReserve
    (reference: getMinBalance, protocol >= 14 sponsorship form)."""
    count = 2 + acc.numSubEntries + num_sponsoring(acc) - num_sponsored(acc)
    return count * header.baseReserve


def available_balance(header: X.LedgerHeader, acc: X.AccountEntry) -> int:
    """Spendable native balance: balance - minBalance - selling liabilities."""
    _, selling = account_liabilities(acc)
    return acc.balance - minimum_balance(header, acc) - selling


def available_limit(acc_or_tl, limit: int, balance: int, buying: int) -> int:
    return limit - balance - buying


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


def add_trustline_balance(tl: X.TrustLineEntry, delta: int) -> bool:
    new = tl.balance + delta
    if new < 0 or new > tl.limit:
        return False
    buying, selling = trustline_liabilities(tl)
    if delta < 0 and new < selling:
        return False
    if delta > 0 and new > tl.limit - buying:
        return False
    tl.balance = new
    return True


def threshold_level_value(acc: X.AccountEntry, level: int) -> int:
    return acc.thresholds[level]


def is_authorized(tl: X.TrustLineEntry) -> bool:
    return bool(tl.flags & X.TrustLineFlags.AUTHORIZED_FLAG)


def is_authorized_to_maintain_liabilities(tl: X.TrustLineEntry) -> bool:
    return bool(tl.flags & (X.TrustLineFlags.AUTHORIZED_FLAG
                            | X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG))


def is_issuer(account_id: X.AccountID, asset: X.Asset) -> bool:
    if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
        return False
    return asset.value.issuer == account_id


def asset_valid(asset: X.Asset) -> bool:
    """Asset code constraints (reference: isAssetValid): alnum, no embedded
    NULs before padding, nonempty."""
    if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
        return True
    code = asset.value.assetCode
    trimmed = code.rstrip(b"\x00")
    if not trimmed or b"\x00" in trimmed:
        return False
    if asset.switch == X.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
        if len(trimmed) > 4:
            return False
    else:
        if len(trimmed) < 5:
            return False
    return all(0x30 <= c <= 0x39 or 0x41 <= c <= 0x5A or 0x61 <= c <= 0x7A
               for c in trimmed)


def add_num_entries(header: X.LedgerHeader, acc: X.AccountEntry,
                    delta: int) -> bool:
    """Adjust numSubEntries with reserve check on increase (reference:
    addNumEntries). Balance floor must cover the new reserve."""
    new_count = acc.numSubEntries + delta
    if new_count < 0:
        return False
    if delta > 0:
        need = (2 + new_count + num_sponsoring(acc) - num_sponsored(acc)) \
            * header.baseReserve
        _, selling = account_liabilities(acc)
        if acc.balance < need + selling:
            return False
    acc.numSubEntries = new_count
    return True
