"""OfferExchange: the order-book crossing engine + liquidity-pool swaps.

Reference: src/transactions/OfferExchange.{h,cpp} — exchangeV10,
adjustOffer, crossOfferV10, convertWithOffersAndPools, getPoolExchange —
and src/transactions/ManageOfferOpFrameBase.cpp liabilities handling.

Terminology follows the reference: for a resting (maker) offer, **wheat**
is the asset the offer sells and **sheep** the asset it buys; its Price is
sheep-per-wheat as the rational n/d.  The taker receives wheat and sends
sheep.  All amount math is exact integer arithmetic (python ints stand in
for the reference's uint128 bigMultiply/bigDivide).

Price-error thresholds (reference: OfferExchange.cpp —
applyPriceErrorThresholds + checkPriceErrorBound): integer rounding can
make the realized price sheepSend/wheatReceive deviate from the offer
price n/d; near dust scale the relative error can be large enough to
betray one side.  The reference cancels an exchange whose relative price
error exceeds 1%, with the upper bound waived when favoring the resting
(wheat) offer cannot betray anyone (path strict-receive, where the path's
sendMax bounds the sender's cost); path strict-send keeps the sent amount
exact and is guarded by the path-level destMin check instead of a
per-exchange bound.  Implemented exactly in integers in
`check_price_error_bound` / `apply_price_error_thresholds` below
(adversarially tested near dust in tests/test_offer_exchange.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, List, Optional, Tuple

from .. import xdr as X
from ..ledger.ledger_txn import LedgerTxn
from . import utils
from .utils import (INT64_MAX, account_key, account_liabilities, add_balance,
                    add_num_entries, asset_to_trustline_asset,
                    available_balance, is_authorized,
                    is_authorized_to_maintain_liabilities, is_issuer,
                    load_account, load_trustline, minimum_balance,
                    trustline_key, trustline_liabilities)

ROUND_NORMAL = 0
ROUND_PATH_STRICT_RECEIVE = 1
ROUND_PATH_STRICT_SEND = 2

# constant-product pool fee: 30 basis points (reference: CAP-38,
# LiquidityPoolConstantProduct maxFee — getPoolFeeBps)
POOL_FEE_BPS = 30


# --------------------------------------------------------------------------
# exact rational helpers

def price_valid(p: X.Price) -> bool:
    return p.n > 0 and p.d > 0


def price_cmp(a: X.Price, b: X.Price) -> int:
    """sign(a - b) by exact cross-multiplication (reference compares prices
    as int128 products; float math is forbidden in consensus code)."""
    lhs = a.n * b.d
    rhs = b.n * a.d
    return (lhs > rhs) - (lhs < rhs)


def _div_round(num: int, den: int, round_up: bool) -> int:
    assert den > 0
    q, r = divmod(num, den)
    if round_up and r:
        q += 1
    return q


@dataclass
class ExchangeResultV10:
    """Reference: OfferExchange.h — ExchangeResultV10."""
    wheat_stays: bool
    num_wheat_received: int
    num_sheep_send: int


def check_price_error_bound(price: X.Price, wheat_receive: int,
                            sheep_send: int, can_favor_wheat: bool) -> bool:
    """Relative price error of the realized exchange vs the offer price
    must be within 1% (reference: OfferExchange.cpp —
    checkPriceErrorBound, exact int128 cross-multiplication there, exact
    python ints here).

    With k = wheatReceive * n and v = sheepSend * d, the realized price
    sheepSend/wheatReceive relative to n/d is v/k, so the bound
    |v - k| <= k/100 is checked as 99*k <= 100*v <= 101*k.
    can_favor_wheat waives the upper bound: overpaying the resting offer
    betrays nobody when the caller bounds total cost elsewhere (path
    strict-receive's sendMax)."""
    k = wheat_receive * price.n
    v = sheep_send * price.d
    if 100 * v < 99 * k:
        return False
    if not can_favor_wheat and 100 * v > 101 * k:
        return False
    return True


def apply_price_error_thresholds(price: X.Price, wheat_receive: int,
                                 sheep_send: int, wheat_stays: bool,
                                 rounding: int) -> ExchangeResultV10:
    """Cancel an exchange whose realized price deviates beyond the error
    bound, and never let one leg round to zero while the other pays
    (reference: OfferExchange.cpp — applyPriceErrorThresholds).  Path
    strict-send has no per-exchange bound: sheepSend is exact and the
    path-level destMin check is the guard."""
    if wheat_receive > 0 and sheep_send > 0:
        if rounding == ROUND_NORMAL and not check_price_error_bound(
                price, wheat_receive, sheep_send, can_favor_wheat=False):
            wheat_receive = sheep_send = 0
        elif rounding == ROUND_PATH_STRICT_RECEIVE and \
                not check_price_error_bound(price, wheat_receive, sheep_send,
                                            can_favor_wheat=True):
            wheat_receive = sheep_send = 0
    if wheat_receive == 0 or sheep_send == 0:
        wheat_receive = sheep_send = 0
    return ExchangeResultV10(wheat_stays, wheat_receive, sheep_send)


def exchange_v10(price: X.Price, max_wheat_send: int, max_wheat_receive: int,
                 max_sheep_send: int, max_sheep_receive: int,
                 rounding: int) -> ExchangeResultV10:
    """Exact crossing amounts for one offer (reference: exchangeV10).

    price: the resting offer's price (sheep per wheat, n/d).
    max_wheat_send: wheat the offer owner can part with (offer amount
        clamped by balance/liabilities).
    max_wheat_receive: wheat the taker can accept (trustline capacity).
    max_sheep_send: sheep the taker can pay.
    max_sheep_receive: sheep the owner can accept.

    Rounding always favors the resting offer (the "wheat stays" side keeps
    the rounding remainder); path-payment strict-send keeps the sent amount
    exact instead of re-deriving it from the floored receive amount.

    wheat_stays compares the *offer side's* executable value
    min(maxWheatSend*n, maxSheepReceive*d) against the *demand side's*
    min(maxSheepSend*d, maxWheatReceive*n) — both in d-scaled sheep units —
    so a taker-capped partial fill never deletes the resting offer.
    """
    # offer side: limited by what it can part with AND what it can accept
    wheat_value = min(max_wheat_send * price.n, max_sheep_receive * price.d)
    # demand side: limited by what the taker can pay AND can accept
    sheep_value = min(max_sheep_send * price.d, max_wheat_receive * price.n)
    if wheat_value <= 0 or sheep_value <= 0:
        return ExchangeResultV10(wheat_value > 0, 0, 0)
    wheat_stays = wheat_value > sheep_value

    if wheat_stays:
        # the demand side is the binding constraint
        wheat_receive = _div_round(sheep_value, price.n, round_up=False)
        if rounding == ROUND_PATH_STRICT_SEND:
            sheep_send = max_sheep_send
        else:
            sheep_send = _div_round(wheat_receive * price.n, price.d,
                                    round_up=True)
    else:
        # the offer is fully consumed
        wheat_receive = _div_round(wheat_value, price.n, round_up=False)
        sheep_send = _div_round(wheat_value, price.d, round_up=True)

    assert wheat_receive <= min(max_wheat_send, max_wheat_receive)
    assert sheep_send <= max_sheep_send
    return apply_price_error_thresholds(price, wheat_receive, sheep_send,
                                        wheat_stays, rounding)


def adjust_offer(price: X.Price, max_wheat_send: int,
                 max_sheep_receive: int) -> int:
    """Reduce a resting offer's amount to what could actually be exchanged
    against an unbounded taker (reference: adjustOffer) — keeps the book
    free of offers that would cross to zero."""
    res = exchange_v10(price, max_wheat_send, INT64_MAX, INT64_MAX,
                       max_sheep_receive, ROUND_NORMAL)
    return res.num_wheat_received


def offer_selling_liabilities(price: X.Price, amount: int) -> int:
    """Reference: getOfferSellingLiabilities."""
    return adjust_offer(price, amount, INT64_MAX)


def offer_buying_liabilities(price: X.Price, amount: int) -> int:
    """Reference: getOfferBuyingLiabilities — the sheep the owner would
    receive if the adjusted offer were fully crossed."""
    res = exchange_v10(price, amount, INT64_MAX, INT64_MAX, INT64_MAX,
                       ROUND_NORMAL)
    return res.num_sheep_send


# --------------------------------------------------------------------------
# liabilities bookkeeping on accounts / trustlines

def _add_liab(entry_mut, asset: X.Asset, d_buying: int, d_selling: int,
              ltx: LedgerTxn) -> bool:
    """Adjust (buying, selling) liabilities for one asset of one account,
    mutating the loaded entry in the ltx.  Native -> AccountEntry ext v1;
    credit -> TrustLineEntry ext v1.  Returns False if the adjustment would
    violate balance/limit constraints (reference: addSellingLiabilities /
    addBuyingLiabilities)."""
    header = ltx.get_header()
    if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
        acc = entry_mut.data.value
        buying, selling = account_liabilities(acc)
        nb, ns = buying + d_buying, selling + d_selling
        if nb < 0 or ns < 0:
            return False
        if ns > acc.balance - minimum_balance(header, acc):
            return False
        if nb > INT64_MAX - acc.balance:
            return False
        _set_account_liab(acc, nb, ns)
        return True
    tl = entry_mut.data.value
    buying, selling = trustline_liabilities(tl)
    nb, ns = buying + d_buying, selling + d_selling
    if nb < 0 or ns < 0:
        return False
    if ns > tl.balance:
        return False
    if nb > tl.limit - tl.balance:
        return False
    _set_trustline_liab(tl, nb, ns)
    return True


def _set_account_liab(acc: X.AccountEntry, buying: int, selling: int) -> None:
    if acc.ext.switch == 0:
        acc.ext = X.AccountEntryExt.v1(X.AccountEntryExtensionV1(
            liabilities=X.Liabilities(buying=buying, selling=selling)))
    else:
        acc.ext.value.liabilities = X.Liabilities(buying=buying,
                                                  selling=selling)


def _set_trustline_liab(tl: X.TrustLineEntry, buying: int,
                        selling: int) -> None:
    if tl.ext.switch == 0:
        tl.ext = X.TrustLineEntryExt.v1(X.TrustLineEntryV1(
            liabilities=X.Liabilities(buying=buying, selling=selling)))
    else:
        tl.ext.value.liabilities = X.Liabilities(buying=buying,
                                                 selling=selling)


def acquire_or_release_offer_liabilities(
        ltx: LedgerTxn, offer: X.OfferEntry, acquire: bool) -> bool:
    """Add (acquire) or remove (release) an offer's liabilities on its
    owner's account/trustlines (reference: acquireLiabilities /
    releaseLiabilities in ManageOfferOpFrameBase)."""
    sign = 1 if acquire else -1
    selling_liab = offer_selling_liabilities(offer.price, offer.amount)
    buying_liab = offer_buying_liabilities(offer.price, offer.amount)
    sid = offer.sellerID

    def entry_for(asset):
        if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            return load_account(ltx, sid)
        if is_issuer(sid, asset):
            return None  # issuers carry no liabilities in their own asset
        return load_trustline(ltx, sid, asset)

    e_sell = entry_for(offer.selling)
    if offer.selling.switch != X.AssetType.ASSET_TYPE_NATIVE \
            and not is_issuer(sid, offer.selling) and e_sell is None:
        return False
    if e_sell is not None:
        if not _add_liab(e_sell, offer.selling, 0, sign * selling_liab, ltx):
            return False
        ltx.update(e_sell)
    e_buy = entry_for(offer.buying)
    if offer.buying.switch != X.AssetType.ASSET_TYPE_NATIVE \
            and not is_issuer(sid, offer.buying) and e_buy is None:
        return False
    if e_buy is not None:
        if not _add_liab(e_buy, offer.buying, sign * buying_liab, 0, ltx):
            return False
        ltx.update(e_buy)
    return True


# --------------------------------------------------------------------------
# book scan

# LedgerKey XDR starts with the 4-byte big-endian union discriminant; match
# on it before paying for a full decode (the book scan sees every key)
_OFFER_TAG = int(X.LedgerEntryType.OFFER).to_bytes(4, "big")


def _iter_offers(ltx: LedgerTxn, selling: X.Asset, buying: X.Asset):
    """All offers selling `selling` for `buying`, decoded."""
    out = []
    for kb in ltx.all_keys():
        if not kb.startswith(_OFFER_TAG):
            continue
        entry = ltx.get_entry(kb)
        if entry is None:
            continue
        offer = entry.data.value
        if offer.selling == selling and offer.buying == buying:
            out.append(offer)
    return out


def load_best_offers(ltx: LedgerTxn, selling: X.Asset,
                     buying: X.Asset) -> List[X.OfferEntry]:
    """Book side sorted by (price ascending, offerID ascending) — the
    reference's loadBestOffer order (LedgerTxnRoot best-offer query).  A
    sorted snapshot is safe during crossing: crossing only mutates/erases
    offers already visited and never inserts new ones."""
    offers = _iter_offers(ltx, selling, buying)
    import functools
    offers.sort(key=functools.cmp_to_key(
        lambda a, b: price_cmp(a.price, b.price) or
        ((a.offerID > b.offerID) - (a.offerID < b.offerID))))
    return offers


def _can_sell_at_most(ltx: LedgerTxn, account_id, asset: X.Asset,
                      header) -> int:
    if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
        acc_e = load_account(ltx, account_id)
        if acc_e is None:
            return 0
        return max(0, available_balance(header, acc_e.data.value))
    if is_issuer(account_id, asset):
        return INT64_MAX
    tl_e = load_trustline(ltx, account_id, asset)
    if tl_e is None or not is_authorized(tl_e.data.value):
        return 0
    tl = tl_e.data.value
    _, selling = trustline_liabilities(tl)
    return max(0, tl.balance - selling)


def _can_buy_at_most(ltx: LedgerTxn, account_id, asset: X.Asset,
                     header) -> int:
    if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
        acc_e = load_account(ltx, account_id)
        if acc_e is None:
            return 0
        acc = acc_e.data.value
        buying, _ = account_liabilities(acc)
        return max(0, INT64_MAX - acc.balance - buying)
    if is_issuer(account_id, asset):
        return INT64_MAX
    tl_e = load_trustline(ltx, account_id, asset)
    if tl_e is None or not is_authorized(tl_e.data.value):
        return 0
    tl = tl_e.data.value
    buying, _ = trustline_liabilities(tl)
    return max(0, tl.limit - tl.balance - buying)


def _transfer(ltx: LedgerTxn, account_id, asset: X.Asset, delta: int,
              header) -> bool:
    """Move `delta` of `asset` into (delta>0) or out of (delta<0) an
    account's balance/trustline; issuers mint/burn (no-op)."""
    if asset.switch != X.AssetType.ASSET_TYPE_NATIVE \
            and is_issuer(account_id, asset):
        return True
    if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
        e = load_account(ltx, account_id)
        if e is None:
            return False
        if not add_balance(e.data.value, delta, header):
            return False
        ltx.update(e)
        return True
    e = load_trustline(ltx, account_id, asset)
    if e is None:
        return False
    if not utils.add_trustline_balance(e.data.value, delta):
        return False
    ltx.update(e)
    return True


# crossing outcomes (reference: OfferExchange.h — ConvertResult /
# CrossOfferResult)
CONVERT_OK = 0
CONVERT_PARTIAL = 1          # book exhausted before the target was reached
CONVERT_FILTER_STOP = 2      # stopped by the price bound / self-cross


@dataclass
class CrossResult:
    """Outcome of a full conversion sweep over one book side."""
    result: int
    wheat_received: int = 0
    sheep_sent: int = 0
    offers_claimed: List[X.ClaimAtom] = dc_field(default_factory=list)
    self_cross: bool = False


def convert_with_offers(
        ltx: LedgerTxn, sheep: X.Asset, wheat: X.Asset,
        max_wheat_receive: int, max_sheep_send: int,
        taker_id, rounding: int,
        price_bound: Optional[Callable[[X.Price], bool]] = None,
) -> CrossResult:
    """Cross the (wheat-selling) book until max_wheat_receive wheat has been
    bought or max_sheep_send sheep spent (reference: convertWithOffers).

    price_bound(maker_price) -> False stops the sweep (used by manage-offer
    crossing to stop at the taker's own price).  Crossing the taker's own
    offer aborts with self_cross (opCROSS_SELF semantics)."""
    header = ltx.get_header()
    res = CrossResult(CONVERT_OK)
    need_wheat = max_wheat_receive
    have_sheep = max_sheep_send

    for offer in load_best_offers(ltx, wheat, sheep):
        if need_wheat <= 0 or have_sheep <= 0:
            break
        if price_bound is not None and not price_bound(offer.price):
            res.result = CONVERT_FILTER_STOP
            break
        if offer.sellerID == taker_id:
            res.self_cross = True
            res.result = CONVERT_FILTER_STOP
            break

        owner = offer.sellerID
        # release the maker's liabilities while the offer is off the book
        if not acquire_or_release_offer_liabilities(ltx, offer, acquire=False):
            # inconsistent offer (should not happen) — skip defensively
            continue
        max_wheat_send = min(offer.amount,
                             _can_sell_at_most(ltx, owner, wheat, header))
        max_sheep_recv = _can_buy_at_most(ltx, owner, sheep, header)
        ex = exchange_v10(offer.price, max_wheat_send, need_wheat,
                          have_sheep, max_sheep_recv, rounding)

        if ex.num_wheat_received > 0:
            assert _transfer(ltx, owner, wheat, -ex.num_wheat_received, header)
            assert _transfer(ltx, owner, sheep, ex.num_sheep_send, header)
            res.offers_claimed.append(X.ClaimAtom.orderBook(X.ClaimOfferAtom(
                sellerID=owner, offerID=offer.offerID,
                assetSold=wheat, amountSold=ex.num_wheat_received,
                assetBought=sheep, amountBought=ex.num_sheep_send)))
            res.wheat_received += ex.num_wheat_received
            res.sheep_sent += ex.num_sheep_send
            need_wheat -= ex.num_wheat_received
            have_sheep -= ex.num_sheep_send

        offer_key = X.LedgerKey.offer(X.LedgerKeyOffer(
            sellerID=owner, offerID=offer.offerID))
        if ex.wheat_stays:
            # offer remains: shrink to the executable remainder and put its
            # liabilities back.  NB: `offer` is a snapshot that may alias the
            # backing store — mutate only a load()ed copy.
            new_amount = adjust_offer(
                offer.price,
                min(offer.amount - ex.num_wheat_received,
                    _can_sell_at_most(ltx, owner, wheat, header)),
                _can_buy_at_most(ltx, owner, sheep, header))
            if new_amount > 0:
                e = ltx.load(offer_key)
                e.data.value.amount = new_amount
                ltx.update(e)
                assert acquire_or_release_offer_liabilities(
                    ltx, e.data.value, acquire=True)
            else:
                _erase_offer(ltx, offer_key, owner, header)
            break  # taker exhausted
        else:
            _erase_offer(ltx, offer_key, owner, header)

    if need_wheat > 0 and have_sheep > 0 and res.result == CONVERT_OK:
        res.result = CONVERT_PARTIAL
    return res


def _erase_offer(ltx: LedgerTxn, offer_key: X.LedgerKey, owner, header):
    """Remove an offer entry and its subentry count, releasing the
    sponsor's reserve when the offer was sponsored (reference:
    removeEntryWithPossibleSponsorship on the crossing path)."""
    from . import sponsorship
    entry = ltx.load(offer_key)
    ltx.erase(offer_key)
    acc_e = load_account(ltx, owner)
    acc = acc_e.data.value
    if entry is not None and sponsorship.entry_sponsor(entry) is not None:
        sponsorship.release_entry_sponsorship(ltx, header, entry, acc_e)
    acc.numSubEntries -= 1
    ltx.update(acc_e)


# --------------------------------------------------------------------------
# liquidity pool swaps (CAP-38 constant product)

def pool_id_for(asset_a: X.Asset, asset_b: X.Asset, fee: int = POOL_FEE_BPS):
    """PoolID = SHA256(xdr(LiquidityPoolParameters)) with assets in
    canonical order (reference: getPoolID)."""
    from ..crypto.sha import sha256
    params = X.LiquidityPoolParameters.constantProduct(
        X.LiquidityPoolConstantProductParameters(
            assetA=asset_a, assetB=asset_b, fee=fee))
    return sha256(params.to_xdr())


def asset_order(a: X.Asset, b: X.Asset) -> int:
    """Canonical asset ordering for pool parameter construction
    (reference: assetA < assetB required)."""
    ka, kb = a.to_xdr(), b.to_xdr()
    return (ka > kb) - (ka < kb)


def pool_swap_out_given_in(reserves_in: int, reserves_out: int,
                           amount_in: int) -> int:
    """Strict-send through a constant-product pool: floor of the CAP-38
    disbursement y = (Y * x * (1-F)) / (X + x * (1-F)), computed exactly in
    basis points."""
    num = reserves_out * amount_in * (10000 - POOL_FEE_BPS)
    den = reserves_in * 10000 + amount_in * (10000 - POOL_FEE_BPS)
    if den <= 0:
        return 0
    return num // den


def pool_swap_in_given_out(reserves_in: int, reserves_out: int,
                           amount_out: int) -> Optional[int]:
    """Strict-receive through a constant-product pool: ceil of
    x = (X * y) / ((Y - y) * (1-F)); None if the pool cannot disburse
    amount_out."""
    if amount_out >= reserves_out:
        return None
    num = reserves_in * amount_out * 10000
    den = (reserves_out - amount_out) * (10000 - POOL_FEE_BPS)
    x = _div_round(num, den, round_up=True)
    if x > INT64_MAX:
        return None
    return x
