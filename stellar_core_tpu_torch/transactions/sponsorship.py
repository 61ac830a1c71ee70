"""SponsorshipUtils — CAP-33 sponsored-reserve bookkeeping.

Reference: src/transactions/SponsorshipUtils.{h,cpp} —
createEntryWithPossibleSponsorship / removeEntryWithPossibleSponsorship /
createSignerWithPossibleSponsorship / removeSignerWithPossibleSponsorship,
computeMultiplier, canEstablishEntrySponsorship, and the
establish/transfer/remove primitives the RevokeSponsorship op builds on.

A transaction-scoped sandwich (BeginSponsoringFutureReserves(A) by S ...
EndSponsoringFutureReserves by A) makes S the sponsor of every reserve
created FOR account A while it is active: new ledger entries owned by A
carry ``ext.v1.sponsoringID = S`` and new signers of A record S in the
account's ``signerSponsoringIDs`` slot aligned with the signer list.
Counts: S.numSponsoring += mult, A.numSponsored += mult, where mult is 2
for an account entry (its two base reserves), #claimants for a claimable
balance and 1 otherwise.  The owner's minimum balance
(2 + numSubEntries + numSponsoring - numSponsored) * baseReserve is then
unchanged by the new subentry — the sponsor's is what grows.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import xdr as X
from . import utils
from .utils import (_ensure_acc_ext_v2, account_liabilities, load_account,
                    num_sponsored, num_sponsoring)

UINT32_MAX = 2 ** 32 - 1

# SponsorshipResult (reference: SponsorshipUtils.h enum class SponsorshipResult)
SUCCESS = 0
LOW_RESERVE = 1
TOO_MANY_SPONSORING = 2
TOO_MANY_SPONSORED = 3


def compute_multiplier(entry: X.LedgerEntry) -> int:
    """Reserve units an entry pins (reference: computeMultiplier): 2 for
    an account (its two base reserves), #claimants for a claimable
    balance, 2 for a pool-share trustline (CAP-38 double subentry), else 1."""
    t = entry.data.switch
    if t == X.LedgerEntryType.ACCOUNT:
        return 2
    if t == X.LedgerEntryType.CLAIMABLE_BALANCE:
        return len(entry.data.value.claimants)
    if t == X.LedgerEntryType.TRUSTLINE and \
            entry.data.value.asset.switch == X.AssetType.ASSET_TYPE_POOL_SHARE:
        return 2
    return 1


def active_sponsor(tx_frame, account_id: X.AccountID) -> Optional[X.AccountID]:
    """The account sponsoring future reserves of `account_id` in this tx,
    if a Begin/End sandwich is currently open for it."""
    ctx = getattr(tx_frame, "_sponsorship_ctx", None)
    if not ctx:
        return None
    sponsor_xdr = ctx.get(account_id.to_xdr())
    if sponsor_xdr is None:
        return None
    return X.AccountID.from_xdr(sponsor_xdr)


def _sponsor_can_take(header: X.LedgerHeader, sponsor: X.AccountEntry,
                      mult: int) -> int:
    """Can `sponsor` take on `mult` more sponsored reserve units?
    (reference: canEstablishEntrySponsorship sponsor-side checks)."""
    if num_sponsoring(sponsor) > UINT32_MAX - mult:
        return TOO_MANY_SPONSORING
    need = (2 + sponsor.numSubEntries + num_sponsoring(sponsor) + mult
            - num_sponsored(sponsor)) * header.baseReserve
    _, selling = account_liabilities(sponsor)
    if sponsor.balance < need + selling:
        return LOW_RESERVE
    return SUCCESS


def _sponsored_can_take(acc: Optional[X.AccountEntry], mult: int) -> int:
    if acc is not None and num_sponsored(acc) > UINT32_MAX - mult:
        return TOO_MANY_SPONSORED
    return SUCCESS


def establish_sponsorship(ltx, header: X.LedgerHeader,
                          sponsor_id: X.AccountID,
                          owner_entry: Optional[X.LedgerEntry],
                          mult: int) -> int:
    """Core counter move: sponsor takes `mult` reserve units (reserve +
    overflow checks), the owner — when there is one — records them as
    sponsored.  The sponsor account is loaded/updated HERE (callers must
    not hold a copy of it); `owner_entry` is mutated in place and updated
    by the caller."""
    sp_e = load_account(ltx, sponsor_id)
    if sp_e is None:
        # unreachable: AccountMerge rejects IS_SPONSOR for any party to an
        # open sandwich (v14+), and merge is the only way an account
        # leaves the ledger — a missing sponsor here means corrupt state
        raise RuntimeError("sandwich sponsor missing from the ledger")
    sponsor = sp_e.data.value
    code = _sponsor_can_take(header, sponsor, mult)
    if code != SUCCESS:
        return code
    owner = owner_entry.data.value if owner_entry is not None else None
    code = _sponsored_can_take(owner, mult)
    if code != SUCCESS:
        return code
    _ensure_acc_ext_v2(sponsor).numSponsoring = num_sponsoring(sponsor) + mult
    sp_e.lastModifiedLedgerSeq = header.ledgerSeq
    ltx.update(sp_e)
    if owner is not None:
        _ensure_acc_ext_v2(owner).numSponsored = num_sponsored(owner) + mult
    return SUCCESS


def establish_entry_sponsorship(ltx, header: X.LedgerHeader,
                                entry: X.LedgerEntry,
                                sponsor_id: X.AccountID,
                                owner_entry: Optional[X.LedgerEntry]) -> int:
    """Record sponsor_id as the sponsor of `entry` and bump the counters.
    `owner_entry` is the (loaded, to-be-updated-by-caller) account that owns
    the reserve, or None for claimable balances."""
    code = establish_sponsorship(ltx, header, sponsor_id, owner_entry,
                                 compute_multiplier(entry))
    if code == SUCCESS:
        entry.ext = X.LedgerEntryExt.v1(X.LedgerEntryExtensionV1(
            sponsoringID=sponsor_id))
    return code


def entry_sponsor(entry: X.LedgerEntry) -> Optional[X.AccountID]:
    if entry.ext.switch == 1:
        return entry.ext.value.sponsoringID
    return None


def release_entry_sponsorship(ltx, header: X.LedgerHeader,
                              entry: X.LedgerEntry,
                              owner_entry: Optional[X.LedgerEntry]) -> None:
    """Undo establish_entry_sponsorship when a sponsored entry leaves the
    ledger (reference: removeEntryWithPossibleSponsorship).  No reserve
    check — releasing only ever frees balance.  The caller updates
    owner_entry; the sponsor is updated here (no-op when unsponsored)."""
    sponsor_id = entry_sponsor(entry)
    if sponsor_id is None:
        return
    mult = compute_multiplier(entry)
    sp_e = load_account(ltx, sponsor_id)
    if sp_e is not None:
        sponsor = sp_e.data.value
        if num_sponsoring(sponsor) < mult:
            raise RuntimeError("sponsoring count underflow")
        _ensure_acc_ext_v2(sponsor).numSponsoring = \
            num_sponsoring(sponsor) - mult
        sp_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(sp_e)
    owner = owner_entry.data.value if owner_entry is not None else None
    if owner is not None:
        if num_sponsored(owner) < mult:
            raise RuntimeError("sponsored count underflow")
        _ensure_acc_ext_v2(owner).numSponsored = num_sponsored(owner) - mult


def create_entry_with_possible_sponsorship(
        ltx, header: X.LedgerHeader, tx_frame, entry: X.LedgerEntry,
        owner_entry: Optional[X.LedgerEntry],
        owner_id: Optional[X.AccountID]) -> Tuple[int, bool]:
    """If a sandwich is active for `owner_id`, sponsor the new entry.
    Returns (SponsorshipResult, sponsored?).  Count/reserve changes for the
    OWNER's numSubEntries are the caller's business (they differ per op);
    this handles only the sponsorship side."""
    if owner_id is None:
        return SUCCESS, False
    sponsor_id = active_sponsor(tx_frame, owner_id)
    if sponsor_id is None:
        return SUCCESS, False
    code = establish_entry_sponsorship(ltx, header, entry, sponsor_id,
                                       owner_entry)
    return code, code == SUCCESS


# --- signer sponsorship ----------------------------------------------------
#
# Signers have no LedgerEntry of their own: the sponsor is recorded in the
# owning account's AccountEntryExtensionV2.signerSponsoringIDs, the list
# kept aligned index-for-index with `signers` (reference: the
# signerSponsoringIDs invariants in AccountEntry).


def signer_sponsoring_ids(acc: X.AccountEntry) -> Optional[list]:
    v2 = utils._acc_ext_v2(acc)
    return v2.signerSponsoringIDs if v2 is not None else None


def _aligned_sponsoring_ids(acc: X.AccountEntry) -> list:
    """The account's signerSponsoringIDs, materialized (ext upgraded to v2)
    and padded to len(signers) with None."""
    v2 = _ensure_acc_ext_v2(acc)
    ids = list(v2.signerSponsoringIDs)
    while len(ids) < len(acc.signers):
        ids.append(None)
    return ids


def record_signer_insert(acc: X.AccountEntry, index: int,
                         sponsor_id: Optional[X.AccountID]) -> None:
    """Keep signerSponsoringIDs aligned after inserting a signer at
    `index`.  Only materializes the v2 extension when there is something to
    record — an unsponsored insert on a v0/v1 account stays v0/v1, so
    pre-sponsorship ledger hashes are unchanged."""
    if sponsor_id is None and utils._acc_ext_v2(acc) is None:
        return
    ids = _aligned_sponsoring_ids(acc)
    ids.insert(index, sponsor_id)
    # the new signer was already inserted into acc.signers by the caller
    del ids[len(acc.signers):]
    utils._acc_ext_v2(acc).signerSponsoringIDs = ids


def record_signer_remove(acc: X.AccountEntry, index: int) -> None:
    """Drop the sponsoring slot of the signer removed at `index` (the
    caller already removed it from acc.signers)."""
    v2 = utils._acc_ext_v2(acc)
    if v2 is None:
        return
    ids = list(v2.signerSponsoringIDs)
    if index < len(ids):
        del ids[index]
    v2.signerSponsoringIDs = ids


def signer_sponsor(acc: X.AccountEntry, index: int) -> Optional[X.AccountID]:
    v2 = utils._acc_ext_v2(acc)
    if v2 is None or index >= len(v2.signerSponsoringIDs):
        return None
    return v2.signerSponsoringIDs[index]


def establish_signer_sponsorship(ltx, header: X.LedgerHeader,
                                 sponsor_id: X.AccountID,
                                 owner_entry: X.LedgerEntry) -> int:
    """Sponsor-side + owner-side counters for one signer (mult=1); the
    sponsoring slot itself is recorded by the caller (record_signer_insert
    or the revoke op's slot write)."""
    return establish_sponsorship(ltx, header, sponsor_id, owner_entry, 1)


def release_signer_sponsorship(ltx, header: X.LedgerHeader,
                               sponsor_id: X.AccountID,
                               owner_entry: X.LedgerEntry) -> None:
    sp_e = load_account(ltx, sponsor_id)
    if sp_e is not None:
        sponsor = sp_e.data.value
        if num_sponsoring(sponsor) < 1:
            raise RuntimeError("sponsoring count underflow (signer)")
        _ensure_acc_ext_v2(sponsor).numSponsoring = num_sponsoring(sponsor) - 1
        sp_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(sp_e)
    owner = owner_entry.data.value
    if num_sponsored(owner) < 1:
        raise RuntimeError("sponsored count underflow (signer)")
    _ensure_acc_ext_v2(owner).numSponsored = num_sponsored(owner) - 1


def owner_can_afford(header: X.LedgerHeader, acc: X.AccountEntry,
                     mult: int) -> bool:
    """After taking back `mult` reserve units (numSponsored -= mult), does
    the owner's balance still cover its minimum?  (reference: the
    LOW_RESERVE arm of removeSponsorship in RevokeSponsorshipOpFrame)."""
    need = (2 + acc.numSubEntries + num_sponsoring(acc)
            - (num_sponsored(acc) - mult)) * header.baseReserve
    _, selling = account_liabilities(acc)
    return acc.balance >= need + selling
