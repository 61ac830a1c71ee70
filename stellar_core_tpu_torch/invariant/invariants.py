"""Invariant framework: optional fail-stop consistency checks on ledger close.

Reference: src/invariant/ — InvariantManagerImpl::{checkOnOperationApply,
checkOnBucketApply}, ConservationOfLumens, AccountSubEntriesCountIsValid,
LiabilitiesMatchOffers, BucketListIsConsistentWithDatabase,
LedgerEntryIsValid.  A violated invariant throws InvariantDoesNotHold and
the node crashes (fail-stop), same as the reference.

Design difference, deliberate: the reference hooks every operation apply
with a per-op LedgerTxnDelta; here the LedgerManager hands the whole
ledger-close delta (pre/post entry pairs + pre/post headers) to the manager
once per close.  Same invariants, coarser granularity — a violation names
the ledger, the tests bisect the op.  This keeps the apply path free of
per-op callback plumbing.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

from .. import xdr as X


class InvariantDoesNotHold(Exception):
    """Fail-stop: raised out of close_ledger, never caught internally."""


def _fail_invariant(msg: str) -> None:
    """Record the violation as a flight event and write a post-mortem
    bundle (util/eventlog → $STPU_CRASH_DIR) before the fail-stop —
    the crash artifact is what the operator reads instead of a bare
    traceback."""
    from ..util import eventlog
    eventlog.record("Invariant", "ERROR", "invariant does not hold",
                    detail=msg)
    eventlog.write_crash_bundle(f"InvariantDoesNotHold: {msg}")
    raise InvariantDoesNotHold(msg)


class LedgerCloseContext:
    """Everything an invariant may inspect for one close.

    pre / post map delta key-bytes -> entry-or-None (None = absent).  Keys
    not in the delta were untouched; `post_state(kb)` falls back to the
    authoritative store for those.
    """

    def __init__(self, pre: Dict[bytes, Optional[X.LedgerEntry]],
                 post: Dict[bytes, Optional[X.LedgerEntry]],
                 pre_header: X.LedgerHeader, post_header: X.LedgerHeader,
                 root_get: Callable[[bytes], Optional[X.LedgerEntry]],
                 all_keys: Callable[[], "list[bytes]"],
                 bucket_list=None):
        self.pre = pre
        self.post = post
        self.pre_header = pre_header
        self.post_header = post_header
        self._root_get = root_get
        self._all_keys = all_keys
        self.bucket_list = bucket_list

    def post_state(self, kb: bytes) -> Optional[X.LedgerEntry]:
        if kb in self.post:
            return self.post[kb]
        return self._root_get(kb)

    def iter_post_keys(self):
        seen = set()
        for kb in self._all_keys():
            seen.add(kb)
            if self.post_state(kb) is not None:
                yield kb
        for kb, e in self.post.items():
            if kb not in seen and e is not None:
                yield kb


class Invariant:
    NAME = "?"
    # invariants that read the bucket list run after add_batch; the rest run
    # before it, so their failure leaves the LedgerManager un-torn (neither
    # root store nor bucket list has advanced)
    NEEDS_BUCKETS = False

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        """Return an error message, or None if the invariant holds."""
        raise NotImplementedError

    def check_on_bucket_apply(self, entry: X.BucketEntry, level: int,
                              header_seq: int) -> Optional[str]:
        """Per-entry check while assuming state from bucket files
        (reference: InvariantManagerImpl::checkOnBucketApply).  Default:
        nothing to check."""
        return None


# ---------------------------------------------------------------------------

def _native_held(entry: Optional[X.LedgerEntry]) -> int:
    """Stroops of native XLM held inside a ledger entry (reference:
    ConservationOfLumens sums balances across accounts, native claimable
    balances and native pool reserves)."""
    if entry is None:
        return 0
    d = entry.data
    t = d.switch
    if t == X.LedgerEntryType.ACCOUNT:
        return d.value.balance
    if t == X.LedgerEntryType.CLAIMABLE_BALANCE:
        cb = d.value
        if cb.asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            return cb.amount
        return 0
    if t == X.LedgerEntryType.LIQUIDITY_POOL:
        cp = d.value.body.value
        held = 0
        if cp.params.assetA.switch == X.AssetType.ASSET_TYPE_NATIVE:
            held += cp.reserveA
        if cp.params.assetB.switch == X.AssetType.ASSET_TYPE_NATIVE:
            held += cp.reserveB
        return held
    return 0


class ConservationOfLumens(Invariant):
    """Σ native held + feePool is constant except for explicit totalCoins
    changes (inflation).  Reference: src/invariant/ConservationOfLumens.cpp."""
    NAME = "ConservationOfLumens"

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        d_held = 0
        for kb in set(ctx.pre) | set(ctx.post):
            d_held += _native_held(ctx.post.get(kb)) \
                - _native_held(ctx.pre.get(kb))
        d_fee = ctx.post_header.feePool - ctx.pre_header.feePool
        d_total = ctx.post_header.totalCoins - ctx.pre_header.totalCoins
        if d_held + d_fee != d_total:
            return (f"lumens not conserved: Δheld={d_held} ΔfeePool={d_fee} "
                    f"ΔtotalCoins={d_total}")
        return None


def _subentry_owner(kb: bytes) -> Optional[Tuple[bytes, int]]:
    """(owner AccountID xdr, subentry weight) for subentry-type keys."""
    key = X.LedgerKey.from_xdr(kb)
    t = key.switch
    if t == X.LedgerEntryType.TRUSTLINE:
        w = 2 if key.value.asset.switch == \
            X.AssetType.ASSET_TYPE_POOL_SHARE else 1
        return key.value.accountID.to_xdr(), w
    if t == X.LedgerEntryType.OFFER:
        return key.value.sellerID.to_xdr(), 1
    if t == X.LedgerEntryType.DATA:
        return key.value.accountID.to_xdr(), 1
    return None


class AccountSubEntriesCountIsValid(Invariant):
    """Δ numSubEntries of each touched account equals the Δ of subentries it
    owns (signers + trustlines [pool share = 2] + offers + data); a deleted
    account owns none afterwards.  Reference:
    src/invariant/AccountSubEntriesCountIsValid.cpp."""
    NAME = "AccountSubEntriesCountIsValid"

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        d_sub: Dict[bytes, int] = {}      # owner -> subentry count delta
        d_declared: Dict[bytes, int] = {}  # owner -> numSubEntries delta
        for kb in set(ctx.pre) | set(ctx.post):
            pre_e, post_e = ctx.pre.get(kb), ctx.post.get(kb)
            owner = _subentry_owner(kb)
            if owner is not None:
                aid, w = owner
                d_sub[aid] = d_sub.get(aid, 0) \
                    + w * ((post_e is not None) - (pre_e is not None))
                continue
            key = X.LedgerKey.from_xdr(kb)
            if key.switch != X.LedgerEntryType.ACCOUNT:
                continue
            aid = key.value.accountID.to_xdr()
            pre_n = pre_e.data.value.numSubEntries if pre_e else 0
            post_n = post_e.data.value.numSubEntries if post_e else 0
            pre_s = len(pre_e.data.value.signers) if pre_e else 0
            post_s = len(post_e.data.value.signers) if post_e else 0
            d_declared[aid] = d_declared.get(aid, 0) + (post_n - pre_n)
            d_sub[aid] = d_sub.get(aid, 0) + (post_s - pre_s)
        # a deleted account needs no special case: merge requires
        # numSubEntries == 0 first, so Δdeclared == Δowned holds uniformly
        # (orphaned subentries left behind would break the equality here)
        for aid in set(d_sub) | set(d_declared):
            if d_sub.get(aid, 0) != d_declared.get(aid, 0):
                return (f"numSubEntries delta {d_declared.get(aid, 0)} != "
                        f"owned subentry delta {d_sub.get(aid, 0)} for "
                        f"account {aid.hex()[:16]}")
        return None


class LiabilitiesMatchOffers(Invariant):
    """For every account/trustline touched this ledger, recorded
    buying/selling liabilities equal the aggregate over that owner's resting
    offers in post state (issuers carry none in their own asset).
    Reference: src/invariant/LiabilitiesMatchOffers.cpp."""
    NAME = "LiabilitiesMatchOffers"

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        from ..transactions.offer_exchange import (
            offer_buying_liabilities, offer_selling_liabilities)
        from ..transactions.utils import is_issuer

        # aggregate liabilities per (owner, asset) over ALL post-state offers
        agg: Dict[Tuple[bytes, bytes], List[int]] = {}  # -> [buying, selling]
        tag = int(X.LedgerEntryType.OFFER).to_bytes(4, "big")
        for kb in ctx.iter_post_keys():
            if not kb.startswith(tag):
                continue
            offer = ctx.post_state(kb).data.value
            sid = offer.sellerID
            if not is_issuer(sid, offer.selling):
                k = (sid.to_xdr(), offer.selling.to_xdr())
                agg.setdefault(k, [0, 0])[1] += \
                    offer_selling_liabilities(offer.price, offer.amount)
            if not is_issuer(sid, offer.buying):
                k = (sid.to_xdr(), offer.buying.to_xdr())
                agg.setdefault(k, [0, 0])[0] += \
                    offer_buying_liabilities(offer.price, offer.amount)

        native = X.Asset(X.AssetType.ASSET_TYPE_NATIVE, None).to_xdr()
        for kb in set(ctx.pre) | set(ctx.post):
            e = ctx.post.get(kb)
            if e is None:
                continue
            t = e.data.switch
            if t == X.LedgerEntryType.ACCOUNT:
                acc = e.data.value
                if acc.ext.switch == 0:
                    rec_b = rec_s = 0
                else:
                    li = acc.ext.value.liabilities
                    rec_b, rec_s = li.buying, li.selling
                want = agg.get((acc.accountID.to_xdr(), native), [0, 0])
                if [rec_b, rec_s] != want:
                    return (f"native liabilities ({rec_b},{rec_s}) != offer "
                            f"aggregate ({want[0]},{want[1]}) for account "
                            f"{acc.accountID.to_xdr().hex()[:16]}")
            elif t == X.LedgerEntryType.TRUSTLINE:
                tl = e.data.value
                if tl.asset.switch == X.AssetType.ASSET_TYPE_POOL_SHARE:
                    continue
                if tl.ext.switch == 0:
                    rec_b = rec_s = 0
                else:
                    li = tl.ext.value.liabilities
                    rec_b, rec_s = li.buying, li.selling
                asset = X.Asset(tl.asset.switch, tl.asset.value).to_xdr()
                want = agg.get((tl.accountID.to_xdr(), asset), [0, 0])
                if [rec_b, rec_s] != want:
                    return (f"trustline liabilities ({rec_b},{rec_s}) != "
                            f"offer aggregate ({want[0]},{want[1]}) for "
                            f"{tl.accountID.to_xdr().hex()[:16]}")
        return None


class BucketListIsConsistentWithDatabase(Invariant):
    """Every key this close touched must read back from the bucket list as
    exactly the post-state entry (or be absent/dead when deleted).
    Reference: src/invariant/BucketListIsConsistentWithDatabase.cpp.

    NB: a violation here means the bucket list itself is corrupt; the
    LedgerManager must be discarded (fail-stop), not reused."""
    NAME = "BucketListIsConsistentWithDatabase"
    NEEDS_BUCKETS = True

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        if ctx.bucket_list is None:
            return None
        for kb in set(ctx.pre) | set(ctx.post):
            want = ctx.post.get(kb)
            got = ctx.bucket_list.lookup_latest(kb)
            if want is None:
                if got is not None:
                    return f"deleted key {kb.hex()[:16]} still live in buckets"
            elif got is None or got.to_xdr() != want.to_xdr():
                return f"bucket entry for {kb.hex()[:16]} != ledger state"
        return None


class LedgerEntryIsValid(Invariant):
    """Structural sanity of written entries (reference:
    src/invariant/LedgerEntryIsValid.cpp — subset: non-negative balances /
    amounts, balance <= limit, lastModified == closing seq)."""
    NAME = "LedgerEntryIsValid"

    @staticmethod
    def _entry_struct_error(e: X.LedgerEntry) -> Optional[str]:
        """Shared per-type structural checks (one source of truth for the
        ledger-close and bucket-apply hooks — the two paths must never
        diverge on what a valid entry is)."""
        t = e.data.switch
        if t == X.LedgerEntryType.ACCOUNT:
            acc = e.data.value
            if acc.balance < 0:
                return "negative account balance"
            if acc.seqNum < 0:
                return "negative seqNum"
        elif t == X.LedgerEntryType.TRUSTLINE:
            tl = e.data.value
            if tl.balance < 0 or tl.limit <= 0 or tl.balance > tl.limit:
                return f"trustline balance {tl.balance} outside [0, {tl.limit}]"
        elif t == X.LedgerEntryType.OFFER:
            off = e.data.value
            if off.amount <= 0 or off.price.n <= 0 or off.price.d <= 0:
                return "non-positive offer amount/price"
        return None

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        seq = ctx.post_header.ledgerSeq
        for kb, e in ctx.post.items():
            if e is None:
                continue
            if e.lastModifiedLedgerSeq != seq:
                return (f"lastModifiedLedgerSeq {e.lastModifiedLedgerSeq} != "
                        f"closing seq {seq} for {kb.hex()[:16]}")
            msg = self._entry_struct_error(e)
            if msg is not None:
                return msg
        return None

    def check_on_bucket_apply(self, entry: X.BucketEntry, level: int,
                              header_seq: int) -> Optional[str]:
        """Structural sanity of entries assumed from an archive's buckets
        (reference: LedgerEntryIsValid under checkOnBucketApply): same
        per-type checks, but lastModified may be any ledger <= the header
        being assumed."""
        if entry.switch in (X.BucketEntryType.DEADENTRY,
                            X.BucketEntryType.METAENTRY):
            return None
        e = entry.value
        where = f"level {level} bucket entry"
        if e.lastModifiedLedgerSeq > header_seq:
            return (f"{where}: lastModifiedLedgerSeq "
                    f"{e.lastModifiedLedgerSeq} is after the assumed "
                    f"header seq {header_seq}")
        msg = self._entry_struct_error(e)
        if msg is not None:
            return f"{where}: {msg}"
        return None


def _sponsorship_units(entry: Optional[X.LedgerEntry]
                       ) -> Optional[Tuple[bytes, int]]:
    """(sponsor AccountID xdr, reserve units) when the entry carries a
    sponsoringID (2 for an account entry, one per claimant for claimable
    balances, 2 for pool-share trustlines, else 1).  Reference:
    computeMultiplier in SponsorshipUtils."""
    if entry is None or entry.ext.switch != 1 \
            or entry.ext.value.sponsoringID is None:
        return None
    from ..transactions.sponsorship import compute_multiplier
    return entry.ext.value.sponsoringID.to_xdr(), compute_multiplier(entry)


def _entry_owner_units(entry: Optional[X.LedgerEntry]
                       ) -> Optional[Tuple[bytes, int]]:
    """(owner AccountID xdr, units) for a SPONSORED entry whose reserve is
    counted in an owner account's numSponsored — accounts own themselves,
    trustlines/data/offers their account; claimable balances are
    owner-less."""
    su = _sponsorship_units(entry)
    if su is None:
        return None
    d = entry.data
    t = d.switch
    if t == X.LedgerEntryType.ACCOUNT:
        return d.value.accountID.to_xdr(), su[1]
    if t in (X.LedgerEntryType.TRUSTLINE, X.LedgerEntryType.DATA):
        return d.value.accountID.to_xdr(), su[1]
    if t == X.LedgerEntryType.OFFER:
        return d.value.sellerID.to_xdr(), su[1]
    return None


def _signer_sponsor_counts(entry: Optional[X.LedgerEntry],
                           sign: int, by_sponsor: Dict[bytes, int],
                           by_owner: Dict[bytes, int]) -> None:
    """Accumulate one account entry's sponsored-signer units into both the
    per-sponsor and per-owner tallies."""
    if entry is None or entry.data.switch != X.LedgerEntryType.ACCOUNT:
        return
    from ..transactions.sponsorship import signer_sponsoring_ids
    ids = signer_sponsoring_ids(entry.data.value)
    if not ids:
        return
    aid = entry.data.value.accountID.to_xdr()
    for sp in ids:
        if sp is not None:
            sb = sp.to_xdr()
            by_sponsor[sb] = by_sponsor.get(sb, 0) + sign
            by_owner[aid] = by_owner.get(aid, 0) + sign


class SponsorshipCountIsValid(Invariant):
    """Δ numSponsoring of each account equals the Δ of reserve units it
    sponsors (entries AND signers), and Δ numSponsored of each account
    equals the Δ of sponsored units it owns.  Reference:
    src/invariant/SponsorshipCountIsValid.cpp."""
    NAME = "SponsorshipCountIsValid"

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        from ..transactions.utils import num_sponsored, num_sponsoring
        d_units: Dict[bytes, int] = {}          # sponsored units BY sponsor
        d_owned: Dict[bytes, int] = {}          # sponsored units ON owner
        d_declared: Dict[bytes, int] = {}       # numSponsoring deltas
        d_declared_ed: Dict[bytes, int] = {}    # numSponsored deltas
        for kb in set(ctx.pre) | set(ctx.post):
            pre_e, post_e = ctx.pre.get(kb), ctx.post.get(kb)
            for e, sign in ((pre_e, -1), (post_e, +1)):
                su = _sponsorship_units(e)
                if su is not None:
                    d_units[su[0]] = d_units.get(su[0], 0) + sign * su[1]
                ou = _entry_owner_units(e)
                if ou is not None:
                    d_owned[ou[0]] = d_owned.get(ou[0], 0) + sign * ou[1]
                _signer_sponsor_counts(e, sign, d_units, d_owned)
            key = X.LedgerKey.from_xdr(kb)
            if key.switch == X.LedgerEntryType.ACCOUNT:
                aid = key.value.accountID.to_xdr()
                pre_n = num_sponsoring(pre_e.data.value) if pre_e else 0
                post_n = num_sponsoring(post_e.data.value) if post_e else 0
                d_declared[aid] = d_declared.get(aid, 0) + post_n - pre_n
                pre_d = num_sponsored(pre_e.data.value) if pre_e else 0
                post_d = num_sponsored(post_e.data.value) if post_e else 0
                d_declared_ed[aid] = d_declared_ed.get(aid, 0) + post_d - pre_d
        for aid in set(d_units) | set(d_declared):
            if d_units.get(aid, 0) != d_declared.get(aid, 0):
                return (f"numSponsoring delta {d_declared.get(aid, 0)} != "
                        f"sponsored-unit delta {d_units.get(aid, 0)} for "
                        f"account {aid.hex()[:16]}")
        for aid in set(d_owned) | set(d_declared_ed):
            if d_owned.get(aid, 0) != d_declared_ed.get(aid, 0):
                return (f"numSponsored delta {d_declared_ed.get(aid, 0)} != "
                        f"owned sponsored-unit delta {d_owned.get(aid, 0)} "
                        f"for account {aid.hex()[:16]}")
        return None


class ConstantProductInvariant(Invariant):
    """Liquidity-pool reserve/share safety (reference:
    src/invariant/ConstantProductInvariant.cpp), guarding pool deposits,
    withdrawals and path payments routed through pools:

    * swaps (total shares unchanged) must not shrink the constant product
      reserveA*reserveB — the 30bp fee makes it grow;
    * deposits (shares up) must not take from either reserve, and must not
      dilute existing holders (minted shares are floored, so the
      per-share value of each reserve never decreases);
    * withdrawals (shares down) must not add to a reserve, and the
      per-share value of each reserve must not decrease (the floor in
      amount = reserve*shares/totalShares favors the pool);
    * a pool leaves the ledger only once empty (no shares, no reserves).
    """
    NAME = "ConstantProductInvariant"

    @staticmethod
    def _cp(entry: Optional[X.LedgerEntry]):
        if entry is None:
            return None
        return entry.data.value.body.value   # LiquidityPoolEntryConstantProduct

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        tag = int(X.LedgerEntryType.LIQUIDITY_POOL).to_bytes(4, "big")
        for kb in set(ctx.pre) | set(ctx.post):
            if not kb.startswith(tag):
                continue
            pre = self._cp(ctx.pre.get(kb))
            post = self._cp(ctx.post.get(kb))
            pid = kb.hex()[8:24]
            if post is not None and (
                    post.reserveA < 0 or post.reserveB < 0
                    or post.totalPoolShares < 0
                    or post.poolSharesTrustLineCount < 0):
                return f"pool {pid}: negative reserve/share/trustline count"
            if pre is None or post is None:
                if post is None and pre is not None and (
                        pre.totalPoolShares != 0 or pre.reserveA != 0
                        or pre.reserveB != 0):
                    return (f"pool {pid} deleted while holding "
                            f"{pre.totalPoolShares} shares / "
                            f"({pre.reserveA},{pre.reserveB}) reserves")
                continue
            ds = post.totalPoolShares - pre.totalPoolShares
            da = post.reserveA - pre.reserveA
            db = post.reserveB - pre.reserveB
            if ds == 0:
                if post.reserveA * post.reserveB \
                        < pre.reserveA * pre.reserveB:
                    return (f"pool {pid}: constant product shrank on swap "
                            f"({pre.reserveA}*{pre.reserveB} -> "
                            f"{post.reserveA}*{post.reserveB})")
            elif ds > 0:
                if da < 0 or db < 0:
                    return (f"pool {pid}: deposit drained a reserve "
                            f"(ΔA={da}, ΔB={db})")
                if post.reserveA * pre.totalPoolShares \
                        < pre.reserveA * post.totalPoolShares \
                        or post.reserveB * pre.totalPoolShares \
                        < pre.reserveB * post.totalPoolShares:
                    return (f"pool {pid}: deposit minted shares worth more "
                            f"than the contributed reserves (dilution)")
            else:
                if da > 0 or db > 0:
                    return (f"pool {pid}: withdrawal grew a reserve "
                            f"(ΔA={da}, ΔB={db})")
                if post.reserveA * pre.totalPoolShares \
                        < pre.reserveA * post.totalPoolShares \
                        or post.reserveB * pre.totalPoolShares \
                        < pre.reserveB * post.totalPoolShares:
                    return (f"pool {pid}: withdrawal paid out more than "
                            f"the burned shares' value")
        return None


class SorobanStateIsValid(Invariant):
    """Contract-state/TTL pairing: every CONTRACT_DATA or
    CONTRACT_CODE entry alive after a close must have a live TTL entry
    (keyHash = sha256 of the data key's XDR), and deleting the data entry
    must delete its TTL in the same close — a dangling TTL would survive
    in buckets forever, and a TTL-less entry could never expire."""
    NAME = "SorobanStateIsValid"

    _DATA_TYPES = (X.LedgerEntryType.CONTRACT_DATA,
                   X.LedgerEntryType.CONTRACT_CODE)

    def check_on_ledger_close(self, ctx: LedgerCloseContext) -> Optional[str]:
        from ..crypto.sha import sha256
        tags = tuple(int(t).to_bytes(4, "big") for t in self._DATA_TYPES)
        for kb in set(ctx.pre) | set(ctx.post):
            if not kb.startswith(tags):
                continue
            ttl_kb = X.LedgerKey.ttl(X.LedgerKeyTtl(
                keyHash=sha256(kb))).to_xdr()
            post = ctx.post.get(kb, ctx.pre.get(kb))
            ttl = ctx.post_state(ttl_kb)
            label = kb.hex()[:16]
            if kb in ctx.post and ctx.post[kb] is None:
                if ttl is not None:
                    return (f"contract entry {label} deleted but its TTL "
                            f"entry survives (liveUntil="
                            f"{ttl.data.value.liveUntilLedgerSeq})")
            elif post is not None:
                if ttl is None:
                    return f"live contract entry {label} has no TTL entry"
                if ttl.data.value.liveUntilLedgerSeq <= 0:
                    return (f"contract entry {label} has non-positive "
                            f"liveUntilLedgerSeq")
        return None


ALL_INVARIANTS = (LedgerEntryIsValid, AccountSubEntriesCountIsValid,
                  ConservationOfLumens, LiabilitiesMatchOffers,
                  SponsorshipCountIsValid, ConstantProductInvariant,
                  SorobanStateIsValid, BucketListIsConsistentWithDatabase)


class InvariantManager:
    """Holds enabled invariants; LedgerManager calls check_on_ledger_close
    once per close.  Reference: InvariantManagerImpl (enabled by the
    INVARIANT_CHECKS config regex list)."""

    def __init__(self, invariants: Optional[List[Invariant]] = None):
        self.invariants: List[Invariant] = (
            [cls() for cls in ALL_INVARIANTS]
            if invariants is None else list(invariants))

    @classmethod
    def from_patterns(cls, patterns: List[str]) -> "InvariantManager":
        """INVARIANT_CHECKS semantics: enable invariants whose name matches
        any regex (the reference config default is [\"(?!.*)\"]=none; tests
        and configs usually pass [\".*\"])."""
        enabled = [c() for c in ALL_INVARIANTS
                   if any(re.fullmatch(p, c.NAME) for p in patterns)]
        return cls(enabled)

    def check_on_ledger_close(self, ctx: LedgerCloseContext,
                              needs_buckets: Optional[bool] = None) -> None:
        """needs_buckets: None = run all; False/True = only the pre-bucket /
        post-bucket phase (LedgerManager runs the two phases around
        add_batch so a pre-bucket violation leaves clean state)."""
        for inv in self.invariants:
            if needs_buckets is not None \
                    and inv.NEEDS_BUCKETS is not needs_buckets:
                continue
            msg = inv.check_on_ledger_close(ctx)
            if msg is not None:
                _fail_invariant(f"{inv.NAME}: {msg}")

    def check_on_bucket_apply(self, bucket, level: int,
                              header_seq: int) -> None:
        """Run per-entry bucket-apply checks over one assumed bucket
        (reference: InvariantManagerImpl::checkOnBucketApply — catchup's
        assume-state path; the hash chain detects corruption, the
        invariant LOCALIZES it to an entry with a message).  Only
        invariants that override the hook walk the entries — bucket lists
        are millions of entries, base-class no-ops are not free."""
        active = [inv for inv in self.invariants
                  if type(inv).check_on_bucket_apply
                  is not Invariant.check_on_bucket_apply]
        for inv in active:
            for be in bucket.entries:
                msg = inv.check_on_bucket_apply(be, level, header_seq)
                if msg is not None:
                    _fail_invariant(f"{inv.NAME}: {msg}")
