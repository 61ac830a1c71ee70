"""Offer, path-payment and liquidity-pool operation frames.

Reference: src/transactions/ManageOfferOpFrameBase.cpp,
ManageSellOfferOpFrame.cpp, ManageBuyOfferOpFrame.cpp,
CreatePassiveSellOfferOpFrame.cpp, PathPaymentOpFrameBase.cpp,
PathPaymentStrictReceiveOpFrame.cpp, PathPaymentStrictSendOpFrame.cpp,
LiquidityPoolDepositOpFrame.cpp, LiquidityPoolWithdrawOpFrame.cpp.

The crossing engine itself lives in offer_exchange.py.
"""

from __future__ import annotations

import math
from typing import List, Optional

from .. import xdr as X
from . import sponsorship, utils
from .offer_exchange import (CONVERT_FILTER_STOP, CONVERT_OK, CONVERT_PARTIAL,
                             ROUND_NORMAL, ROUND_PATH_STRICT_RECEIVE,
                             ROUND_PATH_STRICT_SEND, _can_buy_at_most,
                             _can_sell_at_most, _div_round, _transfer,
                             adjust_offer,
                             acquire_or_release_offer_liabilities,
                             convert_with_offers, pool_id_for, price_valid,
                             pool_swap_in_given_out, pool_swap_out_given_in)
from .operations import OperationFrame, register_op_class
from .utils import (INT64_MAX, account_key, asset_to_trustline_asset,
                    asset_valid, is_authorized, is_issuer, load_account,
                    load_trustline, trustline_key)

OT = X.OperationType
EFF = X.ManageOfferEffect


def _generate_offer_id(ltx) -> int:
    """Reference: LedgerTxnHeader generateID (idPool counter in the ledger
    header)."""
    header = ltx.load_header()
    header.idPool += 1
    ltx.commit_header(header)
    return header.idPool


class _ManageOfferBase(OperationFrame):
    """Shared create/update/delete + crossing logic
    (reference: ManageOfferOpFrameBase)."""

    PASSIVE = False

    # subclasses provide: _params() -> (selling, buying, price, offer_id)
    # and amount semantics via _sheep_budget / _wheat_target

    def _check_offer_valid(self, ltx):
        """Trustline/auth preconditions (reference: checkOfferValid)."""
        C = self.C
        src = self.source_account_id()
        selling, buying = self._selling(), self._buying()
        if selling.switch != X.AssetType.ASSET_TYPE_NATIVE \
                and not is_issuer(src, selling):
            tl = load_trustline(ltx, src, selling)
            if tl is None:
                return self.result(C("SELL_NO_TRUST"))
            if not is_authorized(tl.data.value):
                return self.result(C("SELL_NOT_AUTHORIZED"))
        if buying.switch != X.AssetType.ASSET_TYPE_NATIVE \
                and not is_issuer(src, buying):
            tl = load_trustline(ltx, src, buying)
            if tl is None:
                return self.result(C("BUY_NO_TRUST"))
            if not is_authorized(tl.data.value):
                return self.result(C("BUY_NOT_AUTHORIZED"))
        return None

    def _load_own_offer(self, ltx, offer_id: int):
        key = X.LedgerKey.offer(X.LedgerKeyOffer(
            sellerID=self.source_account_id(), offerID=offer_id))
        return key, ltx.load(key)

    def _apply_manage(self, ltx, selling: X.Asset, buying: X.Asset,
                      price: X.Price, offer_id: int,
                      sell_amount: int) -> X.OperationResult:
        """Create/update/delete + cross.  sell_amount is the desired amount
        in selling-asset units (already converted for buy offers)."""
        C = self.C
        header = ltx.get_header()
        src = self.source_account_id()

        bad = self._check_offer_valid(ltx)
        if bad is not None:
            return bad

        creating = offer_id == 0
        old_flags = 0
        old_ext = None   # preserved across the erase/recreate update path
        if not creating:
            key, existing = self._load_own_offer(ltx, offer_id)
            if existing is None:
                return self.result(C("NOT_FOUND"))
            old = existing.data.value
            old_ext = existing.ext
            # take the old offer off the book (liabilities + entry); it is
            # recreated below if a residual remains
            assert acquire_or_release_offer_liabilities(
                ltx, old, acquire=False)
            ltx.erase(key)
            if sell_amount == 0:
                acc_e = load_account(ltx, src)
                if sponsorship.entry_sponsor(existing) is not None:
                    sponsorship.release_entry_sponsorship(
                        ltx, header, existing, acc_e)
                acc_e.data.value.numSubEntries -= 1
                ltx.update(acc_e)
                return self.success(X.ManageOfferSuccessResult(
                    offersClaimed=[],
                    offer=X.ManageOfferSuccessResultOffer(EFF.MANAGE_OFFER_DELETED)))
        # crossing: we are the taker — we sell `selling` (their sheep), we
        # receive `buying` (their wheat) from offers selling `buying`
        def crossable(maker_price: X.Price) -> bool:
            # maker sells `buying` for `selling` at maker_price; we cross
            # while maker.n * price.n <= maker.d * price.d (maker's ask does
            # not exceed our bid); passive offers skip exact-price makers
            lhs = maker_price.n * price.n
            rhs = maker_price.d * price.d
            return lhs < rhs or (lhs == rhs and not self.PASSIVE)

        max_sheep = min(sell_amount,
                        _can_sell_at_most(ltx, src, selling, header))
        max_wheat = self._wheat_target(ltx, price, sell_amount, header)
        cross = convert_with_offers(
            ltx, selling, buying, max_wheat, max_sheep, src, ROUND_NORMAL,
            price_bound=crossable)
        if cross.self_cross:
            return self.result(C("CROSS_SELF"))
        if not _transfer(ltx, src, selling, -cross.sheep_sent, header):
            return self.result(C("UNDERFUNDED"))
        if not _transfer(ltx, src, buying, cross.wheat_received, header):
            return self.result(C("LINE_FULL"))

        residual = self._residual_sell_amount(
            ltx, price, sell_amount, cross.sheep_sent, cross.wheat_received,
            header)
        effect = EFF.MANAGE_OFFER_CREATED if creating else EFF.MANAGE_OFFER_UPDATED
        new_amount = adjust_offer(
            price, min(residual, _can_sell_at_most(ltx, src, selling, header)),
            _can_buy_at_most(ltx, src, buying, header))
        if new_amount <= 0:
            # fully crossed (or dust): nothing rests on the book
            if not creating:
                acc_e = load_account(ltx, src)
                if sponsorship.entry_sponsor(existing) is not None:
                    sponsorship.release_entry_sponsorship(
                        ltx, header, existing, acc_e)
                acc_e.data.value.numSubEntries -= 1
                ltx.update(acc_e)
            return self.success(X.ManageOfferSuccessResult(
                offersClaimed=cross.offers_claimed,
                offer=X.ManageOfferSuccessResultOffer(EFF.MANAGE_OFFER_DELETED)))

        offer = X.OfferEntry(
            sellerID=src, offerID=offer_id, selling=selling, buying=buying,
            amount=new_amount, price=price,
            flags=X.OfferEntryFlags.PASSIVE_FLAG if self.PASSIVE else 0)
        new_ledger_entry = X.LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=X.LedgerEntryData.offer(offer))
        if creating:
            acc_e = load_account(ltx, src)
            code, sponsored = sponsorship.create_entry_with_possible_sponsorship(
                ltx, header, self.tx, new_ledger_entry, acc_e,
                src if header.ledgerVersion >= 14 else None)
            bad = self.sponsorship_error(code, C("LOW_RESERVE"))
            if bad is not None:
                return bad
            if sponsored:
                acc_e.data.value.numSubEntries += 1
            elif not utils.add_num_entries(header, acc_e.data.value, 1):
                return self.result(C("LOW_RESERVE"))
            ltx.update(acc_e)
            offer_id = _generate_offer_id(ltx)
            offer.offerID = offer_id
        elif old_ext is not None:
            # update path (erase + recreate with the same id): the entry's
            # sponsorship, if any, carries over unchanged
            new_ledger_entry.ext = old_ext
        ltx.create(new_ledger_entry)
        if not acquire_or_release_offer_liabilities(ltx, offer, acquire=True):
            return self.result(C("LINE_FULL"))
        return self.success(X.ManageOfferSuccessResult(
            offersClaimed=cross.offers_claimed,
            offer=X.ManageOfferSuccessResultOffer(effect, offer)))

    # -- amount-semantics hooks (sell vs buy offers) ---------------------
    def _wheat_target(self, ltx, price, sell_amount, header) -> int:
        """How much `buying` the taker is willing to receive during
        crossing — unbounded for sell offers (bounded by sheep budget)."""
        return _can_buy_at_most(ltx, self.source_account_id(),
                                self._buying(), header)

    def _residual_sell_amount(self, ltx, price, sell_amount, sheep_sent,
                              wheat_received, header) -> int:
        return sell_amount - sheep_sent


class ManageSellOfferOpFrame(_ManageOfferBase):
    """Reference: src/transactions/ManageSellOfferOpFrame.cpp."""
    OP_TYPE = OT.MANAGE_SELL_OFFER
    RESULT_CLS = X.ManageSellOfferResult

    def C(self, name):
        return getattr(X.ManageSellOfferResultCode,
                       "MANAGE_SELL_OFFER_" + name)

    def _selling(self):
        return self.body.selling

    def _buying(self):
        return self.body.buying

    def do_check_valid(self, ltx):
        b = self.body
        if (b.amount < 0 or not price_valid(b.price)
                or not asset_valid(b.selling) or not asset_valid(b.buying)
                or b.selling == b.buying or b.offerID < 0
                or (b.amount == 0 and b.offerID == 0)):
            return self.result(self.C("MALFORMED"))
        return self.success()

    def do_apply(self, ltx):
        b = self.body
        return self._apply_manage(ltx, b.selling, b.buying, b.price,
                                  b.offerID, b.amount)


class CreatePassiveSellOfferOpFrame(_ManageOfferBase):
    """Reference: src/transactions/CreatePassiveSellOfferOpFrame.cpp —
    a sell offer that does not cross offers at exactly its own price."""
    OP_TYPE = OT.CREATE_PASSIVE_SELL_OFFER
    RESULT_CLS = X.ManageSellOfferResult
    PASSIVE = True

    def C(self, name):
        return getattr(X.ManageSellOfferResultCode,
                       "MANAGE_SELL_OFFER_" + name)

    def _selling(self):
        return self.body.selling

    def _buying(self):
        return self.body.buying

    def do_check_valid(self, ltx):
        b = self.body
        if (b.amount <= 0 or not price_valid(b.price)
                or not asset_valid(b.selling) or not asset_valid(b.buying)
                or b.selling == b.buying):
            return self.result(self.C("MALFORMED"))
        return self.success()

    def do_apply(self, ltx):
        b = self.body
        return self._apply_manage(ltx, b.selling, b.buying, b.price, 0,
                                  b.amount)


class ManageBuyOfferOpFrame(_ManageOfferBase):
    """Reference: src/transactions/ManageBuyOfferOpFrame.cpp (CAP-0006).

    The op specifies buyAmount in buying-asset units and buyingPrice as
    buying-per-selling... precisely: price of the thing being bought in
    terms of what is being sold.  Stored as a sell offer with the price
    inverted and amount = ceil(buyAmount * price.n / price.d) selling
    units; crossing caps wheat received at buyAmount so the buyer never
    over-buys."""
    MIN_PROTOCOL_VERSION = 11
    OP_TYPE = OT.MANAGE_BUY_OFFER
    RESULT_CLS = X.ManageBuyOfferResult

    def C(self, name):
        return getattr(X.ManageBuyOfferResultCode, "MANAGE_BUY_OFFER_" + name)

    def _selling(self):
        return self.body.selling

    def _buying(self):
        return self.body.buying

    def do_check_valid(self, ltx):
        b = self.body
        if (b.buyAmount < 0 or not price_valid(b.price)
                or not asset_valid(b.selling) or not asset_valid(b.buying)
                or b.selling == b.buying or b.offerID < 0
                or (b.buyAmount == 0 and b.offerID == 0)):
            return self.result(self.C("MALFORMED"))
        return self.success()

    def _sell_price(self) -> X.Price:
        return X.Price(n=self.body.price.d, d=self.body.price.n)

    def do_apply(self, ltx):
        b = self.body
        if b.buyAmount == 0:
            sell_amount = 0
        else:
            # selling units needed to buy buyAmount at price (round up so
            # the resting offer can always fill the requested buy amount)
            sell_amount = _div_round(b.buyAmount * b.price.n, b.price.d,
                                     round_up=True)
            if sell_amount > INT64_MAX:
                return self.result(self.C("MALFORMED"))
        return self._apply_manage(ltx, b.selling, b.buying,
                                  self._sell_price(), b.offerID, sell_amount)

    def _wheat_target(self, ltx, price, sell_amount, header) -> int:
        cap = _can_buy_at_most(ltx, self.source_account_id(),
                               self._buying(), header)
        return min(self.body.buyAmount, cap)

    def _residual_sell_amount(self, ltx, price, sell_amount, sheep_sent,
                              wheat_received, header) -> int:
        # residual is driven by the un-bought amount, reconverted to
        # selling units at the op's buy price (NOT the inverted stored one)
        left = self.body.buyAmount - wheat_received
        if left <= 0:
            return 0
        return _div_round(left * self.body.price.n, self.body.price.d,
                          round_up=True)


# --------------------------------------------------------------------------
# path payments

class _PathPaymentBase(OperationFrame):
    """Reference: src/transactions/PathPaymentOpFrameBase.cpp."""

    def _dest_id(self):
        return X.muxed_to_account_id(self.body.destination)

    def _check_common(self):
        C = self.C
        b = self.body
        assets = [b.sendAsset, *b.path, b.destAsset]
        for a in assets:
            if not asset_valid(a):
                return self.result(C("MALFORMED"))
        if len(b.path) > 5:
            return self.result(C("MALFORMED"))
        return None

    def _credit_dest(self, ltx, amount: int) -> Optional[X.OperationResult]:
        """Credit destAsset to the destination, with the reference's result
        codes for missing account/trustline/auth/limit."""
        C = self.C
        header = ltx.get_header()
        dest = self._dest_id()
        asset = self.body.destAsset
        if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            e = load_account(ltx, dest)
            if e is None:
                return self.result(C("NO_DESTINATION"))
            if not utils.add_balance(e.data.value, amount, header):
                return self.result(C("LINE_FULL"))
            ltx.update(e)
            return None
        if is_issuer(dest, asset):
            if ltx.get_entry(account_key(dest).to_xdr()) is None:
                return self.result(C("NO_DESTINATION"))
            return None  # burning at the issuer
        if ltx.get_entry(account_key(dest).to_xdr()) is None:
            return self.result(C("NO_DESTINATION"))
        tl = load_trustline(ltx, dest, asset)
        if tl is None:
            return self.result(C("NO_TRUST"))
        if not is_authorized(tl.data.value):
            return self.result(C("NOT_AUTHORIZED"))
        if not utils.add_trustline_balance(tl.data.value, amount):
            return self.result(C("LINE_FULL"))
        ltx.update(tl)
        return None

    def _debit_source(self, ltx, amount: int) -> Optional[X.OperationResult]:
        C = self.C
        header = ltx.get_header()
        src = self.source_account_id()
        asset = self.body.sendAsset
        if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            e = load_account(ltx, src)
            if not utils.add_balance(e.data.value, -amount, header):
                return self.result(C("UNDERFUNDED"))
            ltx.update(e)
            return None
        if is_issuer(src, asset):
            return None  # minting from the issuer
        tl = load_trustline(ltx, src, asset)
        if tl is None:
            return self.result(C("SRC_NO_TRUST"))
        if not is_authorized(tl.data.value):
            return self.result(C("SRC_NOT_AUTHORIZED"))
        if not utils.add_trustline_balance(tl.data.value, -amount):
            return self.result(C("UNDERFUNDED"))
        ltx.update(tl)
        return None

    def _convert_hop(self, ltx, from_asset: X.Asset, to_asset: X.Asset,
                     wheat_target: int, sheep_budget: int, rounding: int):
        """One hop: cross the book selling `to_asset` for `from_asset`,
        choosing the order book or the constant-product pool — whichever
        converts at the better rate (reference:
        convertWithOffersAndPoolsStrictReceive/Send, CAP-38).  Returns
        (result_or_None, wheat_received, sheep_sent, claims)."""
        from ..ledger.ledger_txn import LedgerTxn

        # order-book attempt in a child txn so the loser can be rolled back
        book_txn = LedgerTxn(ltx)
        book = convert_with_offers(
            book_txn, from_asset, to_asset, wheat_target, sheep_budget,
            self.source_account_id(), rounding)
        if book.self_cross:
            book_txn.rollback()
            return self.result(self.C("OFFER_CROSS_SELF")), 0, 0, []

        pool = self._pool_quote(ltx, from_asset, to_asset, wheat_target,
                                sheep_budget, rounding)

        book_filled = (rounding == ROUND_PATH_STRICT_RECEIVE
                       and book.wheat_received >= wheat_target) or \
                      (rounding == ROUND_PATH_STRICT_SEND
                       and book.sheep_sent >= sheep_budget)

        def use_pool():
            book_txn.rollback()
            pid, in_amt, out_amt, ra, rb, flip = pool
            pool_key = X.LedgerKey.liquidityPool(
                X.LedgerKeyLiquidityPool(liquidityPoolID=pid))
            pe = ltx.load(pool_key)
            cp = pe.data.value.body.value
            if flip:
                cp.reserveB += in_amt
                cp.reserveA -= out_amt
            else:
                cp.reserveA += in_amt
                cp.reserveB -= out_amt
            ltx.update(pe)
            claim = X.ClaimAtom.liquidityPool(X.ClaimLiquidityAtom(
                liquidityPoolID=pid, assetSold=to_asset, amountSold=out_amt,
                assetBought=from_asset, amountBought=in_amt))
            return None, out_amt, in_amt, [claim]

        if pool is not None:
            if rounding == ROUND_PATH_STRICT_RECEIVE:
                # pool can deliver the full target; better price == less in
                if pool[2] >= wheat_target and (
                        not book_filled or pool[1] < book.sheep_sent):
                    return use_pool()
            else:
                if pool[1] <= sheep_budget and pool[2] > book.wheat_received:
                    return use_pool()

        book_txn.commit()
        if rounding == ROUND_PATH_STRICT_RECEIVE \
                and book.wheat_received < wheat_target:
            return self.result(self.C("TOO_FEW_OFFERS")), 0, 0, []
        if rounding == ROUND_PATH_STRICT_SEND and book.sheep_sent < sheep_budget:
            return self.result(self.C("TOO_FEW_OFFERS")), 0, 0, []
        return None, book.wheat_received, book.sheep_sent, book.offers_claimed

    def _pool_quote(self, ltx, from_asset, to_asset, wheat_target,
                    sheep_budget, rounding):
        """(pool_id, amount_in, amount_out, reserve_in, reserve_out, flip)
        or None if no usable pool exists for the pair."""
        from .offer_exchange import asset_order
        a, b = ((from_asset, to_asset)
                if asset_order(from_asset, to_asset) < 0
                else (to_asset, from_asset))
        pid = pool_id_for(a, b)
        pe = ltx.get_entry(X.LedgerKey.liquidityPool(
            X.LedgerKeyLiquidityPool(liquidityPoolID=pid)).to_xdr())
        if pe is None:
            return None
        cp = pe.data.value.body.value
        flip = from_asset == cp.params.assetB
        r_in = cp.reserveB if flip else cp.reserveA
        r_out = cp.reserveA if flip else cp.reserveB
        if r_in <= 0 or r_out <= 0:
            return None
        if rounding == ROUND_PATH_STRICT_RECEIVE:
            amount_out = wheat_target
            amount_in = pool_swap_in_given_out(r_in, r_out, amount_out)
            if amount_in is None:
                return None
        else:
            amount_in = sheep_budget
            amount_out = pool_swap_out_given_in(r_in, r_out, amount_in)
            if amount_out <= 0:
                return None
        # reference getPoolExchange: skip the pool rather than overflow its
        # post-swap reserve
        if r_in + amount_in > INT64_MAX:
            return None
        return pid, amount_in, amount_out, r_in, r_out, flip


class PathPaymentStrictReceiveOpFrame(_PathPaymentBase):
    """Reference: src/transactions/PathPaymentStrictReceiveOpFrame.cpp —
    fixed destAmount, bounded sendMax, path walked destination-first."""
    OP_TYPE = OT.PATH_PAYMENT_STRICT_RECEIVE
    RESULT_CLS = X.PathPaymentStrictReceiveResult

    def C(self, name):
        return getattr(X.PathPaymentStrictReceiveResultCode,
                       "PATH_PAYMENT_STRICT_RECEIVE_" + name)

    def do_check_valid(self, ltx):
        b = self.body
        if b.destAmount <= 0 or b.sendMax <= 0:
            return self.result(self.C("MALFORMED"))
        bad = self._check_common()
        return bad if bad is not None else self.success()

    def do_apply(self, ltx):
        b = self.body
        bad = self._credit_dest(ltx, b.destAmount)
        if bad is not None:
            return bad
        chain = [b.sendAsset, *b.path, b.destAsset]
        claims: List[X.ClaimAtom] = []
        need = b.destAmount
        # walk back from the destination: each hop buys `need` of the next
        # asset with the previous one
        for i in range(len(chain) - 1, 0, -1):
            to_asset, from_asset = chain[i], chain[i - 1]
            if to_asset == from_asset:
                continue
            bad, wheat, sheep, hop_claims = self._convert_hop(
                ltx, from_asset, to_asset, need, INT64_MAX,
                ROUND_PATH_STRICT_RECEIVE)
            if bad is not None:
                return bad
            claims = hop_claims + claims
            need = sheep
        if need > b.sendMax:
            return self.result(self.C("OVER_SENDMAX"))
        bad = self._debit_source(ltx, need)
        if bad is not None:
            return bad
        last = X.SimplePaymentResult(
            destination=self._dest_id(), asset=b.destAsset,
            amount=b.destAmount)
        return self.success(X.PathPaymentStrictReceiveResultSuccess(
            offers=claims, last=last))


class PathPaymentStrictSendOpFrame(_PathPaymentBase):
    """Reference: src/transactions/PathPaymentStrictSendOpFrame.cpp —
    fixed sendAmount, bounded destMin, path walked source-first."""
    MIN_PROTOCOL_VERSION = 12
    OP_TYPE = OT.PATH_PAYMENT_STRICT_SEND
    RESULT_CLS = X.PathPaymentStrictSendResult

    def C(self, name):
        return getattr(X.PathPaymentStrictSendResultCode,
                       "PATH_PAYMENT_STRICT_SEND_" + name)

    def do_check_valid(self, ltx):
        b = self.body
        if b.sendAmount <= 0 or b.destMin <= 0:
            return self.result(self.C("MALFORMED"))
        bad = self._check_common()
        return bad if bad is not None else self.success()

    def do_apply(self, ltx):
        b = self.body
        bad = self._debit_source(ltx, b.sendAmount)
        if bad is not None:
            return bad
        chain = [b.sendAsset, *b.path, b.destAsset]
        claims: List[X.ClaimAtom] = []
        have = b.sendAmount
        for i in range(len(chain) - 1):
            from_asset, to_asset = chain[i], chain[i + 1]
            if from_asset == to_asset:
                continue
            bad, wheat, sheep, hop_claims = self._convert_hop(
                ltx, from_asset, to_asset, INT64_MAX, have,
                ROUND_PATH_STRICT_SEND)
            if bad is not None:
                return bad
            claims.extend(hop_claims)
            have = wheat
        if have < b.destMin:
            return self.result(self.C("UNDER_DESTMIN"))
        bad = self._credit_dest(ltx, have)
        if bad is not None:
            return bad
        last = X.SimplePaymentResult(
            destination=self._dest_id(), asset=b.destAsset, amount=have)
        return self.success(X.PathPaymentStrictSendResultSuccess(
            offers=claims, last=last))


# --------------------------------------------------------------------------
# liquidity pools

def _isqrt(n: int) -> int:
    return math.isqrt(n)


def _pool_trustline(ltx, account_id, pool_id):
    key = trustline_key(account_id,
                        X.TrustLineAsset.liquidityPoolID(pool_id))
    return key, ltx.load(key)


class LiquidityPoolDepositOpFrame(OperationFrame):
    """Reference: src/transactions/LiquidityPoolDepositOpFrame.cpp."""
    MIN_PROTOCOL_VERSION = 18
    OP_TYPE = OT.LIQUIDITY_POOL_DEPOSIT
    RESULT_CLS = X.LiquidityPoolDepositResult

    def C(self, name):
        return getattr(X.LiquidityPoolDepositResultCode,
                       "LIQUIDITY_POOL_DEPOSIT_" + name)

    def do_check_valid(self, ltx):
        b = self.body
        if (b.maxAmountA <= 0 or b.maxAmountB <= 0
                or not price_valid(b.minPrice) or not price_valid(b.maxPrice)
                or b.minPrice.n * b.maxPrice.d > b.maxPrice.n * b.minPrice.d):
            return self.result(self.C("MALFORMED"))
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        b = self.body
        header = ltx.get_header()
        src = self.source_account_id()
        _, tl_e = _pool_trustline(ltx, src, b.liquidityPoolID)
        if tl_e is None:
            return self.result(C("NO_TRUST"))
        pool_key = X.LedgerKey.liquidityPool(
            X.LedgerKeyLiquidityPool(liquidityPoolID=b.liquidityPoolID))
        pe = ltx.load(pool_key)
        if pe is None:
            return self.result(C("NO_TRUST"))
        cp = pe.data.value.body.value
        asset_a, asset_b = cp.params.assetA, cp.params.assetB

        if cp.totalPoolShares == 0:
            amount_a, amount_b = b.maxAmountA, b.maxAmountB
            # deposit price = a/b must lie within [minPrice, maxPrice]
            if (amount_a * b.minPrice.d < amount_b * b.minPrice.n
                    or amount_a * b.maxPrice.d > amount_b * b.maxPrice.n):
                return self.result(C("BAD_PRICE"))
            shares = _isqrt(amount_a * amount_b)
        else:
            # maximal deposit at the pool price within the sender's bounds
            shares_a = cp.totalPoolShares * b.maxAmountA // cp.reserveA
            shares_b = cp.totalPoolShares * b.maxAmountB // cp.reserveB
            shares = min(shares_a, shares_b)
            amount_a = -(-shares * cp.reserveA // cp.totalPoolShares)
            amount_b = -(-shares * cp.reserveB // cp.totalPoolShares)
            if amount_a > b.maxAmountA or amount_b > b.maxAmountB:
                shares -= 1
                amount_a = -(-shares * cp.reserveA // cp.totalPoolShares)
                amount_b = -(-shares * cp.reserveB // cp.totalPoolShares)
            if shares <= 0 or amount_a <= 0 or amount_b <= 0:
                return self.result(C("UNDERFUNDED"))
            # pool price must lie within bounds
            if (cp.reserveA * b.minPrice.d < cp.reserveB * b.minPrice.n
                    or cp.reserveA * b.maxPrice.d > cp.reserveB * b.maxPrice.n):
                return self.result(C("BAD_PRICE"))

        if cp.totalPoolShares > INT64_MAX - shares \
                or cp.reserveA > INT64_MAX - amount_a \
                or cp.reserveB > INT64_MAX - amount_b:
            return self.result(C("POOL_FULL"))
        # move the deposits in
        if not self._spend(ltx, src, asset_a, amount_a, header):
            return self.result(C("UNDERFUNDED"))
        if not self._spend(ltx, src, asset_b, amount_b, header):
            return self.result(C("UNDERFUNDED"))
        tl = tl_e.data.value
        if not utils.add_trustline_balance(tl, shares):
            return self.result(C("LINE_FULL"))
        ltx.update(tl_e)
        cp.reserveA += amount_a
        cp.reserveB += amount_b
        cp.totalPoolShares += shares
        ltx.update(pe)
        return self.success()

    @staticmethod
    def _spend(ltx, src, asset, amount, header) -> bool:
        if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            e = load_account(ltx, src)
            if e is None or not utils.add_balance(e.data.value, -amount,
                                                  header):
                return False
            ltx.update(e)
            return True
        if is_issuer(src, asset):
            return True
        tl = load_trustline(ltx, src, asset)
        if tl is None or not is_authorized(tl.data.value) \
                or not utils.add_trustline_balance(tl.data.value, -amount):
            return False
        ltx.update(tl)
        return True


class LiquidityPoolWithdrawOpFrame(OperationFrame):
    """Reference: src/transactions/LiquidityPoolWithdrawOpFrame.cpp."""
    MIN_PROTOCOL_VERSION = 18
    OP_TYPE = OT.LIQUIDITY_POOL_WITHDRAW
    RESULT_CLS = X.LiquidityPoolWithdrawResult

    def C(self, name):
        return getattr(X.LiquidityPoolWithdrawResultCode,
                       "LIQUIDITY_POOL_WITHDRAW_" + name)

    def do_check_valid(self, ltx):
        b = self.body
        if b.amount <= 0 or b.minAmountA < 0 or b.minAmountB < 0:
            return self.result(self.C("MALFORMED"))
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        b = self.body
        header = ltx.get_header()
        src = self.source_account_id()
        _, tl_e = _pool_trustline(ltx, src, b.liquidityPoolID)
        if tl_e is None:
            return self.result(C("NO_TRUST"))
        tl = tl_e.data.value
        if tl.balance < b.amount:
            return self.result(C("UNDERFUNDED"))
        pool_key = X.LedgerKey.liquidityPool(
            X.LedgerKeyLiquidityPool(liquidityPoolID=b.liquidityPoolID))
        pe = ltx.load(pool_key)
        cp = pe.data.value.body.value
        amount_a = b.amount * cp.reserveA // cp.totalPoolShares
        amount_b = b.amount * cp.reserveB // cp.totalPoolShares
        if amount_a < b.minAmountA or amount_b < b.minAmountB:
            return self.result(C("UNDER_MINIMUM"))
        if not self._receive(ltx, src, cp.params.assetA, amount_a, header):
            return self.result(C("LINE_FULL"))
        if not self._receive(ltx, src, cp.params.assetB, amount_b, header):
            return self.result(C("LINE_FULL"))
        assert utils.add_trustline_balance(tl, -b.amount)
        ltx.update(tl_e)
        cp.reserveA -= amount_a
        cp.reserveB -= amount_b
        cp.totalPoolShares -= b.amount
        ltx.update(pe)
        return self.success()

    @staticmethod
    def _receive(ltx, src, asset, amount, header) -> bool:
        if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            e = load_account(ltx, src)
            if e is None or not utils.add_balance(e.data.value, amount,
                                                  header):
                return False
            ltx.update(e)
            return True
        if is_issuer(src, asset):
            return True
        tl = load_trustline(ltx, src, asset)
        if tl is None or not utils.add_trustline_balance(tl.data.value,
                                                         amount):
            return False
        ltx.update(tl)
        return True


for _cls in (ManageSellOfferOpFrame, ManageBuyOfferOpFrame,
             CreatePassiveSellOfferOpFrame, PathPaymentStrictReceiveOpFrame,
             PathPaymentStrictSendOpFrame, LiquidityPoolDepositOpFrame,
             LiquidityPoolWithdrawOpFrame):
    register_op_class(_cls.OP_TYPE, _cls)
