"""Operation frames: per-op checkValid + doApply.

Reference: src/transactions/OperationFrame.{h,cpp} (dispatch, thresholds,
source auth) and one <Name>OpFrame.{h,cpp} per operation (SURVEY.md §2.2).
Protocol level: current classic semantics.

Implemented here: CreateAccount, Payment, ManageData, BumpSequence,
SetOptions, ChangeTrust, AllowTrust, AccountMerge, Inflation,
CreateClaimableBalance, ClaimClaimableBalance, Clawback,
ClawbackClaimableBalance, SetTrustLineFlags, and the full CAP-33
sponsorship set (Begin/End/RevokeSponsorship with per-entry and per-signer
reserve bookkeeping — see sponsorship.py).  Offers, path payments and
liquidity pools live in offer_exchange.py; the Soroban trio
(InvokeHostFunction / ExtendFootprintTTL / RestoreFootprint) lives in
soroban/ops.py against the bounded built-in host (no wasm, SURVEY §2.4).
"""

from __future__ import annotations

from typing import Optional

from .. import xdr as X
from ..crypto.sha import sha256
from ..ledger.ledger_txn import LedgerTxn
from . import sponsorship, utils
from .signature_checker import SignatureChecker
from .utils import (INT64_MAX, THRESHOLD_HIGH, THRESHOLD_LOW, THRESHOLD_MED,
                    add_balance, add_num_entries,
                    add_trustline_balance, asset_to_trustline_asset,
                    asset_valid, cb_key, data_key, is_authorized,
                    is_authorized_to_maintain_liabilities, is_issuer,
                    load_account, load_trustline, trustline_key)

OT = X.OperationType
ORC = X.OperationResultCode


def make_op_frame(tx_frame, index: int, op: X.Operation) -> "OperationFrame":
    cls = _OP_CLASSES.get(op.body.switch, UnsupportedOpFrame)
    return cls(tx_frame, index, op)


def _inner(op_type: OT, result_union_cls, code, value=None) -> X.OperationResult:
    res = result_union_cls(code, value)
    return X.OperationResult.tr(X.OperationResultTr(op_type, res))


class OperationFrame:
    OP_TYPE: OT = None
    RESULT_CLS = None
    # ledgerVersion that introduced this operation (reference: each op
    # frame's isVersionSupported / isOpSupported gate); 0 = always
    MIN_PROTOCOL_VERSION = 0

    def __init__(self, tx_frame, index: int, op: X.Operation):
        self.tx = tx_frame
        self.index = index
        self.op = op
        self.body = op.body.value

    # -- source & auth ------------------------------------------------------
    def source_account_id(self) -> X.AccountID:
        if self.op.sourceAccount is not None:
            return X.muxed_to_account_id(self.op.sourceAccount)
        return self.tx.source_account_id()

    def threshold_level(self) -> int:
        return THRESHOLD_MED

    def check_signatures(self, checker: SignatureChecker,
                         ltx: LedgerTxn) -> Optional[X.OperationResult]:
        acc_entry = ltx.get_entry(
            X.account_key_xdr(self.source_account_id().value))
        if acc_entry is None:
            return X.OperationResult(ORC.opNO_ACCOUNT)
        from .frame import check_account_signature
        if not check_account_signature(checker, acc_entry.data.value,
                                       self.threshold_level()):
            return X.OperationResult(ORC.opBAD_AUTH)
        return None

    # -- protocol -----------------------------------------------------------
    def check_valid(self, checker: SignatureChecker,
                    ltx: LedgerTxn) -> X.OperationResult:
        if ltx.get_header().ledgerVersion < self.MIN_PROTOCOL_VERSION:
            return X.OperationResult(ORC.opNOT_SUPPORTED)
        bad = self.check_signatures(checker, ltx)
        if bad is not None:
            return bad
        return self.do_check_valid(ltx)

    def do_check_valid(self, ltx: LedgerTxn) -> X.OperationResult:
        return self.success()

    def do_apply(self, ltx: LedgerTxn) -> X.OperationResult:
        raise NotImplementedError

    # -- result helpers ------------------------------------------------------
    def result(self, code, value=None) -> X.OperationResult:
        return _inner(self.OP_TYPE, self.RESULT_CLS, code, value)

    def success(self, value=None) -> X.OperationResult:
        return self.result(self.RESULT_CLS._switch_type.enum_cls(0), value)

    def sponsorship_error(self, code: int,
                          low_reserve_code) -> Optional[X.OperationResult]:
        """Map a SponsorshipResult to this op's result: None on SUCCESS,
        the op-specific LOW_RESERVE on reserve failure, the outer
        opTOO_MANY_SPONSORING on counter overflow (the real XDR has no
        opTOO_MANY_SPONSORED; the reference maps both overflows here)."""
        if code == sponsorship.SUCCESS:
            return None
        if code == sponsorship.LOW_RESERVE:
            return self.result(low_reserve_code)
        return X.OperationResult(ORC.opTOO_MANY_SPONSORING)


class UnsupportedOpFrame(OperationFrame):
    def check_valid(self, checker, ltx):
        bad = self.check_signatures(checker, ltx)
        if bad is not None:
            return bad
        return X.OperationResult(ORC.opNOT_SUPPORTED)

    def do_apply(self, ltx):
        return X.OperationResult(ORC.opNOT_SUPPORTED)


# --------------------------------------------------------------------------

class CreateAccountOpFrame(OperationFrame):
    """Reference: src/transactions/CreateAccountOpFrame.cpp."""
    OP_TYPE = OT.CREATE_ACCOUNT
    RESULT_CLS = X.CreateAccountResult
    C = X.CreateAccountResultCode

    def do_check_valid(self, ltx):
        # v14+ (CAP-33) allows startingBalance == 0 — a sponsored account
        # needs no balance of its own; pre-v14 requires > 0
        min_ok = (self.body.startingBalance >= 0
                  if ltx.get_header().ledgerVersion >= 14
                  else self.body.startingBalance > 0)
        if not min_ok:
            return self.result(self.C.CREATE_ACCOUNT_MALFORMED)
        if self.body.destination == self.source_account_id():
            return self.result(self.C.CREATE_ACCOUNT_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        header = ltx.get_header()
        dest_key = utils.account_key(self.body.destination)
        if ltx.exists(dest_key):
            return self.result(self.C.CREATE_ACCOUNT_ALREADY_EXIST)
        new_acc = X.AccountEntry(
            accountID=self.body.destination,
            balance=self.body.startingBalance,
            seqNum=starting_sequence_number(header))
        new_entry = X.LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=X.LedgerEntryData.account(new_acc))
        sponsor_id = (sponsorship.active_sponsor(self.tx, self.body.destination)
                      if header.ledgerVersion >= 14 else None)
        if sponsor_id is not None:
            # sponsored create: the sponsor's reserve covers the new
            # account's 2 base reserves (mult=2); checked BEFORE the source
            # pays the starting balance, so the sponsor check sees the
            # pre-transfer state.  The source is loaded only afterwards —
            # the sandwich sponsor may BE the op source, and a copy held
            # across establish would clobber its numSponsoring update.
            code = sponsorship.establish_entry_sponsorship(
                ltx, header, new_entry, sponsor_id, new_entry)
            bad = self.sponsorship_error(
                code, self.C.CREATE_ACCOUNT_LOW_RESERVE)
            if bad is not None:
                return bad
        elif self.body.startingBalance < 2 * header.baseReserve:
            return self.result(self.C.CREATE_ACCOUNT_LOW_RESERVE)
        src_e = load_account(ltx, self.source_account_id())
        src = src_e.data.value
        if not add_balance(src, -self.body.startingBalance, header):
            return self.result(self.C.CREATE_ACCOUNT_UNDERFUNDED)
        ltx.update(src_e)
        ltx.create(new_entry)
        return self.success()


def starting_sequence_number(header: X.LedgerHeader) -> int:
    """ledgerSeq << 32 (reference: getStartingSequenceNumber)."""
    return header.ledgerSeq << 32


class PaymentOpFrame(OperationFrame):
    """Reference: src/transactions/PaymentOpFrame.cpp (native + credit)."""
    OP_TYPE = OT.PAYMENT
    RESULT_CLS = X.PaymentResult
    C = X.PaymentResultCode

    def do_check_valid(self, ltx):
        if self.body.amount <= 0:
            return self.result(self.C.PAYMENT_MALFORMED)
        if not asset_valid(self.body.asset):
            return self.result(self.C.PAYMENT_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        header = ltx.get_header()
        asset = self.body.asset
        amount = self.body.amount
        src_id = self.source_account_id()
        dest_id = X.muxed_to_account_id(self.body.destination)

        dest_e = load_account(ltx, dest_id)
        if dest_e is None:
            return self.result(self.C.PAYMENT_NO_DESTINATION)

        if asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            src_e = load_account(ltx, src_id)
            src = src_e.data.value
            if src_id == dest_id:
                return self.success()
            if not add_balance(src, -amount, header):
                return self.result(self.C.PAYMENT_UNDERFUNDED)
            dest = dest_e.data.value
            if not add_balance(dest, amount):
                return self.result(self.C.PAYMENT_LINE_FULL)
            src_e.lastModifiedLedgerSeq = header.ledgerSeq
            dest_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(src_e)
            ltx.update(dest_e)
            return self.success()

        issuer = asset.value.issuer
        # source side
        if not is_issuer(src_id, asset):
            src_tl_e = load_trustline(ltx, src_id, asset)
            if src_tl_e is None:
                return self.result(self.C.PAYMENT_SRC_NO_TRUST)
            src_tl = src_tl_e.data.value
            if not is_authorized(src_tl):
                return self.result(self.C.PAYMENT_SRC_NOT_AUTHORIZED)
            if not add_trustline_balance(src_tl, -amount):
                return self.result(self.C.PAYMENT_UNDERFUNDED)
            src_tl_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(src_tl_e)
        # destination side
        if not is_issuer(dest_id, asset):
            dest_tl_e = load_trustline(ltx, dest_id, asset)
            if dest_tl_e is None:
                return self.result(self.C.PAYMENT_NO_TRUST)
            dest_tl = dest_tl_e.data.value
            if not is_authorized(dest_tl):
                return self.result(self.C.PAYMENT_NOT_AUTHORIZED)
            if not add_trustline_balance(dest_tl, amount):
                return self.result(self.C.PAYMENT_LINE_FULL)
            dest_tl_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(dest_tl_e)
        return self.success()


class ManageDataOpFrame(OperationFrame):
    """Reference: src/transactions/ManageDataOpFrame.cpp."""
    OP_TYPE = OT.MANAGE_DATA
    RESULT_CLS = X.ManageDataResult
    C = X.ManageDataResultCode

    def do_check_valid(self, ltx):
        name = self.body.dataName
        if not name or len(name) > 64:
            return self.result(self.C.MANAGE_DATA_INVALID_NAME)
        try:
            name.decode("ascii")
        except UnicodeDecodeError:
            return self.result(self.C.MANAGE_DATA_INVALID_NAME)
        return self.success()

    def do_apply(self, ltx):
        header = ltx.get_header()
        src_id = self.source_account_id()
        key = data_key(src_id, self.body.dataName)
        existing = ltx.load(key)
        src_e = load_account(ltx, src_id)
        src = src_e.data.value
        if self.body.dataValue is None:
            if existing is None:
                return self.result(self.C.MANAGE_DATA_NAME_NOT_FOUND)
            ltx.erase(key)
            if sponsorship.entry_sponsor(existing) is not None:
                sponsorship.release_entry_sponsorship(
                    ltx, header, existing, src_e)
                src.numSubEntries -= 1
            else:
                add_num_entries(header, src, -1)
            ltx.update(src_e)
            return self.success()
        if existing is None:
            new_entry = X.LedgerEntry(
                lastModifiedLedgerSeq=header.ledgerSeq,
                data=X.LedgerEntryData.data(X.DataEntry(
                    accountID=src_id, dataName=self.body.dataName,
                    dataValue=self.body.dataValue)))
            code, sponsored = sponsorship.create_entry_with_possible_sponsorship(
                ltx, header, self.tx, new_entry, src_e,
                src_id if header.ledgerVersion >= 14 else None)
            bad = self.sponsorship_error(
                code, self.C.MANAGE_DATA_LOW_RESERVE)
            if bad is not None:
                return bad
            if sponsored:
                src.numSubEntries += 1
            elif not add_num_entries(header, src, 1):
                return self.result(self.C.MANAGE_DATA_LOW_RESERVE)
            ltx.update(src_e)
            ltx.create(new_entry)
        else:
            existing.data.value.dataValue = self.body.dataValue
            existing.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(existing)
        return self.success()


class BumpSequenceOpFrame(OperationFrame):
    """Reference: src/transactions/BumpSequenceOpFrame.cpp.  LOW threshold."""
    MIN_PROTOCOL_VERSION = 10
    OP_TYPE = OT.BUMP_SEQUENCE
    RESULT_CLS = X.BumpSequenceResult
    C = X.BumpSequenceResultCode

    def threshold_level(self):
        return THRESHOLD_LOW

    def do_check_valid(self, ltx):
        if self.body.bumpTo < 0:
            return self.result(self.C.BUMP_SEQUENCE_BAD_SEQ)
        return self.success()

    def do_apply(self, ltx):
        header = ltx.get_header()
        src_e = load_account(ltx, self.source_account_id())
        src = src_e.data.value
        max_seq = (header.ledgerSeq + 1) << 32
        if self.body.bumpTo > (2 ** 63 - 1):
            return self.result(self.C.BUMP_SEQUENCE_BAD_SEQ)
        if self.body.bumpTo > src.seqNum:
            src.seqNum = self.body.bumpTo
            src_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(src_e)
        return self.success()


class SetOptionsOpFrame(OperationFrame):
    """Reference: src/transactions/SetOptionsOpFrame.cpp.  HIGH threshold."""
    OP_TYPE = OT.SET_OPTIONS
    RESULT_CLS = X.SetOptionsResult
    C = X.SetOptionsResultCode

    def threshold_level(self):
        return THRESHOLD_HIGH

    def do_check_valid(self, ltx):
        b = self.body
        C = self.C
        for t in (b.masterWeight, b.lowThreshold, b.medThreshold, b.highThreshold):
            if t is not None and t > 255:
                return self.result(C.SET_OPTIONS_THRESHOLD_OUT_OF_RANGE)
        if b.setFlags is not None and b.clearFlags is not None \
                and (b.setFlags & b.clearFlags) != 0:
            return self.result(C.SET_OPTIONS_BAD_FLAGS)
        mask = X.MASK_ACCOUNT_FLAGS_V17
        if (b.setFlags is not None and b.setFlags & ~mask) or \
                (b.clearFlags is not None and b.clearFlags & ~mask):
            return self.result(C.SET_OPTIONS_UNKNOWN_FLAG)
        if b.homeDomain is not None:
            try:
                b.homeDomain.decode("ascii")
            except UnicodeDecodeError:
                return self.result(C.SET_OPTIONS_INVALID_HOME_DOMAIN)
        if b.signer is not None:
            if b.signer.key == X.SignerKey.ed25519(
                    self.source_account_id().value):
                return self.result(C.SET_OPTIONS_BAD_SIGNER)
            if b.signer.weight > 255:
                return self.result(C.SET_OPTIONS_BAD_SIGNER)
        return self.success()

    def do_apply(self, ltx):
        b = self.body
        C = self.C
        header = ltx.get_header()
        src_e = load_account(ltx, self.source_account_id())
        src = src_e.data.value
        if b.inflationDest is not None:
            if not ltx.exists(utils.account_key(b.inflationDest)):
                return self.result(C.SET_OPTIONS_INVALID_INFLATION)
            src.inflationDest = b.inflationDest
        if b.clearFlags is not None:
            if (src.flags & X.AccountFlags.AUTH_IMMUTABLE_FLAG):
                return self.result(C.SET_OPTIONS_CANT_CHANGE)
            src.flags &= ~b.clearFlags
        if b.setFlags is not None:
            if (src.flags & X.AccountFlags.AUTH_IMMUTABLE_FLAG):
                return self.result(C.SET_OPTIONS_CANT_CHANGE)
            src.flags |= b.setFlags
        th = bytearray(src.thresholds)
        if b.masterWeight is not None:
            th[0] = b.masterWeight
        if b.lowThreshold is not None:
            th[1] = b.lowThreshold
        if b.medThreshold is not None:
            th[2] = b.medThreshold
        if b.highThreshold is not None:
            th[3] = b.highThreshold
        src.thresholds = bytes(th)
        if b.homeDomain is not None:
            src.homeDomain = b.homeDomain
        if b.signer is not None:
            signers = list(src.signers)
            idx = next((i for i, s in enumerate(signers)
                        if s.key == b.signer.key), None)
            if b.signer.weight == 0:
                if idx is not None:
                    sponsor_id = sponsorship.signer_sponsor(src, idx)
                    signers.pop(idx)
                    src.signers = signers
                    sponsorship.record_signer_remove(src, idx)
                    if sponsor_id is not None:
                        # sponsored signer: release the sponsor's reserve,
                        # no reserve movement on the owner
                        sponsorship.release_signer_sponsorship(
                            ltx, header, sponsor_id, src_e)
                        src.numSubEntries -= 1
                    elif not add_num_entries(header, src, -1):
                        return self.result(C.SET_OPTIONS_LOW_RESERVE)
            elif idx is not None:
                # weight update: sponsorship (if any) is untouched
                signers[idx] = b.signer
                src.signers = signers
            else:
                if len(signers) >= X.MAX_SIGNERS:
                    return self.result(C.SET_OPTIONS_TOO_MANY_SIGNERS)
                sponsor_id = (sponsorship.active_sponsor(
                    self.tx, self.source_account_id())
                    if header.ledgerVersion >= 14 else None)
                if sponsor_id is not None:
                    code = sponsorship.establish_signer_sponsorship(
                        ltx, header, sponsor_id, src_e)
                    bad = self.sponsorship_error(
                        code, C.SET_OPTIONS_LOW_RESERVE)
                    if bad is not None:
                        return bad
                    src.numSubEntries += 1
                elif not add_num_entries(header, src, 1):
                    return self.result(C.SET_OPTIONS_LOW_RESERVE)
                # sorted insert keeps signerSponsoringIDs index-aligned
                key = b.signer.key.to_xdr()
                pos = next((i for i, s in enumerate(signers)
                            if s.key.to_xdr() > key), len(signers))
                signers.insert(pos, b.signer)
                src.signers = signers
                sponsorship.record_signer_insert(src, pos, sponsor_id)
        src_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(src_e)
        return self.success()


class ChangeTrustOpFrame(OperationFrame):
    """Reference: src/transactions/ChangeTrustOpFrame.cpp (classic assets
    and CAP-38 pool-share trustlines)."""
    OP_TYPE = OT.CHANGE_TRUST
    RESULT_CLS = X.ChangeTrustResult
    C = X.ChangeTrustResultCode

    def do_check_valid(self, ltx):
        line = self.body.line
        if line.switch == X.AssetType.ASSET_TYPE_POOL_SHARE:
            params = line.value.value  # LiquidityPoolParameters.constantProduct
            from .offer_exchange import POOL_FEE_BPS, asset_order
            if (not asset_valid(params.assetA) or not asset_valid(params.assetB)
                    or asset_order(params.assetA, params.assetB) >= 0
                    or params.fee != POOL_FEE_BPS or self.body.limit < 0):
                return self.result(self.C.CHANGE_TRUST_MALFORMED)
            return self.success()
        if line.switch == X.AssetType.ASSET_TYPE_NATIVE:
            return self.result(self.C.CHANGE_TRUST_MALFORMED)
        asset = X.Asset(line.switch, line.value)
        if not asset_valid(asset):
            return self.result(self.C.CHANGE_TRUST_MALFORMED)
        if self.body.limit < 0:
            return self.result(self.C.CHANGE_TRUST_MALFORMED)
        if is_issuer(self.source_account_id(), asset):
            return self.result(self.C.CHANGE_TRUST_SELF_NOT_ALLOWED)
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        if self.body.line.switch == X.AssetType.ASSET_TYPE_POOL_SHARE:
            return self._apply_pool_share(ltx)
        header = ltx.get_header()
        src_id = self.source_account_id()
        asset = X.Asset(self.body.line.switch, self.body.line.value)
        key = trustline_key(src_id, asset_to_trustline_asset(asset))
        existing = ltx.load(key)
        src_e = load_account(ltx, src_id)
        src = src_e.data.value
        if existing is None:
            if self.body.limit == 0:
                return self.result(C.CHANGE_TRUST_INVALID_LIMIT)
            issuer_e = ltx.get_entry(
                utils.account_key(asset.value.issuer).to_xdr())
            if issuer_e is None:
                return self.result(C.CHANGE_TRUST_NO_ISSUER)
            flags = 0
            issuer = issuer_e.data.value
            if not (issuer.flags & X.AccountFlags.AUTH_REQUIRED_FLAG):
                flags |= X.TrustLineFlags.AUTHORIZED_FLAG
            if issuer.flags & X.AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG:
                flags |= X.TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG
            new_entry = X.LedgerEntry(
                lastModifiedLedgerSeq=header.ledgerSeq,
                data=X.LedgerEntryData.trustLine(X.TrustLineEntry(
                    accountID=src_id,
                    asset=asset_to_trustline_asset(asset),
                    balance=0, limit=self.body.limit, flags=flags)))
            code, sponsored = sponsorship.create_entry_with_possible_sponsorship(
                ltx, header, self.tx, new_entry, src_e,
                src_id if header.ledgerVersion >= 14 else None)
            bad = self.sponsorship_error(code, C.CHANGE_TRUST_LOW_RESERVE)
            if bad is not None:
                return bad
            if sponsored:
                src.numSubEntries += 1
            elif not add_num_entries(header, src, 1):
                return self.result(C.CHANGE_TRUST_LOW_RESERVE)
            ltx.update(src_e)
            ltx.create(new_entry)
            return self.success()
        tl = existing.data.value
        if self.body.limit == 0:
            if tl.balance != 0:
                return self.result(C.CHANGE_TRUST_INVALID_LIMIT)
            buying, selling = utils.trustline_liabilities(tl)
            if buying or selling:
                return self.result(C.CHANGE_TRUST_CANNOT_DELETE)
            ltx.erase(key)
            if sponsorship.entry_sponsor(existing) is not None:
                sponsorship.release_entry_sponsorship(
                    ltx, header, existing, src_e)
                src.numSubEntries -= 1
            else:
                add_num_entries(header, src, -1)
            ltx.update(src_e)
            return self.success()
        buying, _ = utils.trustline_liabilities(tl)
        if self.body.limit < tl.balance + buying:
            return self.result(C.CHANGE_TRUST_INVALID_LIMIT)
        if not ltx.exists(utils.account_key(asset.value.issuer)):
            return self.result(C.CHANGE_TRUST_NO_ISSUER)
        tl.limit = self.body.limit
        existing.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(existing)
        return self.success()

    def _apply_pool_share(self, ltx):
        """CAP-38 pool-share trustline create/update/delete: requires
        trustlines to both non-native constituents, counts 2 subentries,
        and maintains the LiquidityPoolEntry's poolSharesTrustLineCount
        plus each constituent trustline's liquidityPoolUseCount
        (reference: ChangeTrustOpFrame::tryIncrementPoolUseCount)."""
        from .offer_exchange import pool_id_for
        C = self.C
        header = ltx.get_header()
        src_id = self.source_account_id()
        params = self.body.line.value.value
        pool_id = pool_id_for(params.assetA, params.assetB, params.fee)
        key = trustline_key(src_id, X.TrustLineAsset.liquidityPoolID(pool_id))
        existing = ltx.load(key)
        src_e = load_account(ltx, src_id)
        src = src_e.data.value
        pool_key = X.LedgerKey.liquidityPool(
            X.LedgerKeyLiquidityPool(liquidityPoolID=pool_id))

        if existing is None:
            if self.body.limit == 0:
                return self.result(C.CHANGE_TRUST_INVALID_LIMIT)
            # constituents: native needs nothing; credit assets need an
            # authorized trustline, whose pool-use count we bump
            for asset in (params.assetA, params.assetB):
                if asset.switch == X.AssetType.ASSET_TYPE_NATIVE \
                        or is_issuer(src_id, asset):
                    continue
                tl_e = utils.load_trustline(ltx, src_id, asset)
                if tl_e is None:
                    return self.result(C.CHANGE_TRUST_TRUST_LINE_MISSING)
                # CAP-38: maintain-liabilities suffices for pool membership
                if not utils.is_authorized_to_maintain_liabilities(
                        tl_e.data.value):
                    return self.result(C.CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES)
                self._bump_pool_use(tl_e, +1)
                ltx.update(tl_e)
            new_tl_entry = X.LedgerEntry(
                lastModifiedLedgerSeq=header.ledgerSeq,
                data=X.LedgerEntryData.trustLine(X.TrustLineEntry(
                    accountID=src_id,
                    asset=X.TrustLineAsset.liquidityPoolID(pool_id),
                    balance=0, limit=self.body.limit,
                    flags=X.TrustLineFlags.AUTHORIZED_FLAG)))
            code, sponsored = sponsorship.create_entry_with_possible_sponsorship(
                ltx, header, self.tx, new_tl_entry, src_e,
                src_id if header.ledgerVersion >= 18 else None)
            bad = self.sponsorship_error(code, C.CHANGE_TRUST_LOW_RESERVE)
            if bad is not None:
                return bad
            if sponsored:
                src.numSubEntries += 2
            elif not add_num_entries(header, src, 2):
                return self.result(C.CHANGE_TRUST_LOW_RESERVE)
            ltx.update(src_e)
            pe = ltx.load(pool_key)
            if pe is None:
                cp = X.LiquidityPoolEntryConstantProduct(
                    params=params, reserveA=0, reserveB=0,
                    totalPoolShares=0, poolSharesTrustLineCount=1)
                ltx.create(X.LedgerEntry(
                    lastModifiedLedgerSeq=header.ledgerSeq,
                    data=X.LedgerEntryData.liquidityPool(X.LiquidityPoolEntry(
                        liquidityPoolID=pool_id,
                        body=X.LiquidityPoolEntryBody.constantProduct(cp)))))
            else:
                pe.data.value.body.value.poolSharesTrustLineCount += 1
                ltx.update(pe)
            ltx.create(new_tl_entry)
            return self.success()

        tl = existing.data.value
        if self.body.limit == 0:
            if tl.balance != 0:
                return self.result(C.CHANGE_TRUST_INVALID_LIMIT)
            ltx.erase(key)
            if sponsorship.entry_sponsor(existing) is not None:
                sponsorship.release_entry_sponsorship(
                    ltx, header, existing, src_e)
                src.numSubEntries -= 2
            else:
                add_num_entries(header, src, -2)
            ltx.update(src_e)
            pe = ltx.load(pool_key)
            cp = pe.data.value.body.value
            cp.poolSharesTrustLineCount -= 1
            if cp.poolSharesTrustLineCount == 0:
                ltx.erase(pool_key)
            else:
                ltx.update(pe)
            for asset in (params.assetA, params.assetB):
                if asset.switch == X.AssetType.ASSET_TYPE_NATIVE \
                        or is_issuer(src_id, asset):
                    continue
                tl_e = utils.load_trustline(ltx, src_id, asset)
                if tl_e is not None:
                    self._bump_pool_use(tl_e, -1)
                    ltx.update(tl_e)
            return self.success()
        if self.body.limit < tl.balance:
            return self.result(C.CHANGE_TRUST_INVALID_LIMIT)
        tl.limit = self.body.limit
        existing.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(existing)
        return self.success()

    @staticmethod
    def _bump_pool_use(tl_entry, delta: int) -> None:
        """Adjust TrustLineEntry ext-v2 liquidityPoolUseCount."""
        tl = tl_entry.data.value
        if tl.ext.switch == 0:
            tl.ext = X.TrustLineEntryExt.v1(X.TrustLineEntryV1(
                liabilities=X.Liabilities(buying=0, selling=0)))
        v1 = tl.ext.value
        if v1.ext.switch != 2:
            v1.ext = X.TrustLineEntryV1Ext.v2(X.TrustLineEntryExtensionV2(
                liquidityPoolUseCount=0))
        v1.ext.value.liquidityPoolUseCount += delta


class AllowTrustOpFrame(OperationFrame):
    """Reference: src/transactions/AllowTrustOpFrame.cpp.  LOW threshold."""
    OP_TYPE = OT.ALLOW_TRUST
    RESULT_CLS = X.AllowTrustResult
    C = X.AllowTrustResultCode

    def threshold_level(self):
        return THRESHOLD_LOW

    def do_check_valid(self, ltx):
        if self.body.authorize > (X.TrustLineFlags.AUTHORIZED_FLAG
                                  | X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG):
            return self.result(self.C.ALLOW_TRUST_MALFORMED)
        if (self.body.authorize & X.TrustLineFlags.AUTHORIZED_FLAG) and \
                (self.body.authorize & X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG):
            return self.result(self.C.ALLOW_TRUST_MALFORMED)
        code = self.body.asset
        probe = X.Asset(code.switch, X.AlphaNum4(
            assetCode=code.value, issuer=self.source_account_id())
            if code.switch == X.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4
            else X.AlphaNum12(assetCode=code.value,
                              issuer=self.source_account_id()))
        if not asset_valid(probe):
            return self.result(self.C.ALLOW_TRUST_MALFORMED)
        if self.body.trustor == self.source_account_id():
            return self.result(self.C.ALLOW_TRUST_SELF_NOT_ALLOWED)
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        header = ltx.get_header()
        src_id = self.source_account_id()
        src_e = load_account(ltx, src_id)
        src = src_e.data.value
        if not (src.flags & X.AccountFlags.AUTH_REQUIRED_FLAG) \
                and self.body.authorize != 0:
            pass  # issuing auth when not required is allowed (no-op flagging)
        if not (src.flags & X.AccountFlags.AUTH_REVOCABLE_FLAG) \
                and self.body.authorize != X.TrustLineFlags.AUTHORIZED_FLAG:
            return self.result(C.ALLOW_TRUST_CANT_REVOKE)
        code = self.body.asset
        if code.switch == X.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
            asset = X.Asset.alphaNum4(X.AlphaNum4(assetCode=code.value,
                                                  issuer=src_id))
        else:
            asset = X.Asset.alphaNum12(X.AlphaNum12(assetCode=code.value,
                                                    issuer=src_id))
        tl_e = load_trustline(ltx, self.body.trustor, asset)
        if tl_e is None:
            return self.result(C.ALLOW_TRUST_NO_TRUST_LINE)
        tl = tl_e.data.value
        auth_mask = (X.TrustLineFlags.AUTHORIZED_FLAG
                     | X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)
        tl.flags = (tl.flags & ~auth_mask) | self.body.authorize
        tl_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(tl_e)
        return self.success()


class AccountMergeOpFrame(OperationFrame):
    """Reference: src/transactions/MergeOpFrame.cpp.  HIGH threshold."""
    OP_TYPE = OT.ACCOUNT_MERGE
    RESULT_CLS = X.AccountMergeResult
    C = X.AccountMergeResultCode

    def threshold_level(self):
        return THRESHOLD_HIGH

    def do_check_valid(self, ltx):
        dest = X.muxed_to_account_id(self.op.body.value)
        if dest == self.source_account_id():
            return self.result(self.C.ACCOUNT_MERGE_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        header = ltx.get_header()
        src_id = self.source_account_id()
        dest_id = X.muxed_to_account_id(self.op.body.value)
        dest_e = load_account(ltx, dest_id)
        if dest_e is None:
            return self.result(C.ACCOUNT_MERGE_NO_ACCOUNT)
        src_e = load_account(ltx, src_id)
        src = src_e.data.value
        if src.flags & X.AccountFlags.AUTH_IMMUTABLE_FLAG:
            return self.result(C.ACCOUNT_MERGE_IMMUTABLE_SET)
        if header.ledgerVersion >= 14:
            # CAP-33 (reference: MergeOpFrame via loadSponsorship /
            # loadSponsorshipCounter): a party to an OPEN Begin/End
            # sandwich — sponsored account OR sponsor — cannot merge away
            # mid-tx; this is also what keeps the sandwich sponsor loadable
            # for the rest of the tx (see establish_sponsorship)
            ctx = getattr(self.tx, "_sponsorship_ctx", None) or {}
            src_x = src_id.to_xdr()
            if src_x in ctx or src_x in ctx.values():
                return self.result(C.ACCOUNT_MERGE_IS_SPONSOR)
        if src.numSubEntries != 0:
            return self.result(C.ACCOUNT_MERGE_HAS_SUB_ENTRIES)
        if utils.num_sponsoring(src) != 0:
            return self.result(C.ACCOUNT_MERGE_IS_SPONSOR)
        # seqnum too far: src seq >= max seq for current ledger
        if src.seqNum >= ((header.ledgerSeq + 1) << 32) - 1 \
                and src.seqNum == 2 ** 63 - 1:
            return self.result(C.ACCOUNT_MERGE_SEQNUM_TOO_FAR)
        balance = src.balance
        dest = dest_e.data.value
        if not add_balance(dest, balance):
            return self.result(C.ACCOUNT_MERGE_DEST_FULL)
        dest_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(dest_e)
        # a sponsored account entry releases its sponsor's 2 reserve units
        # when it leaves the ledger (removeEntryWithPossibleSponsorship);
        # the dying account's own numSponsored vanishes with it
        sponsorship.release_entry_sponsorship(ltx, header, src_e, None)
        ltx.erase(utils.account_key(src_id))
        return self.result(C.ACCOUNT_MERGE_SUCCESS, balance)


class InflationOpFrame(OperationFrame):
    """Reference: src/transactions/InflationOpFrame.cpp — inflation is
    disabled from protocol 12 (always NOT_TIME)."""
    OP_TYPE = OT.INFLATION
    RESULT_CLS = X.InflationResult
    C = X.InflationResultCode

    def do_apply(self, ltx):
        return self.result(self.C.INFLATION_NOT_TIME)


class CreateClaimableBalanceOpFrame(OperationFrame):
    """Reference: src/transactions/CreateClaimableBalanceOpFrame.cpp."""
    MIN_PROTOCOL_VERSION = 14
    OP_TYPE = OT.CREATE_CLAIMABLE_BALANCE
    RESULT_CLS = X.CreateClaimableBalanceResult
    C = X.CreateClaimableBalanceResultCode

    def do_check_valid(self, ltx):
        b = self.body
        if b.amount <= 0 or not asset_valid(b.asset) or not b.claimants:
            return self.result(self.C.CREATE_CLAIMABLE_BALANCE_MALFORMED)
        dests = set()
        for c in b.claimants:
            dests.add(c.value.destination.to_xdr())
            if not _predicate_valid(c.value.predicate):
                return self.result(self.C.CREATE_CLAIMABLE_BALANCE_MALFORMED)
        if len(dests) != len(b.claimants):
            return self.result(self.C.CREATE_CLAIMABLE_BALANCE_MALFORMED)
        return self.success()

    def balance_id(self, ltx: LedgerTxn) -> X.ClaimableBalanceID:
        """sha256(OperationID preimage) (reference: getBalanceID)."""
        pre = X.HashIDPreimage(
            X.EnvelopeType.ENVELOPE_TYPE_OP_ID,
            X.OperationIDId(sourceAccount=self.tx.source_account_id(),
                            seqNum=self.tx.seq_num, opNum=self.index))
        return X.ClaimableBalanceID.v0(sha256(pre.to_xdr()))

    def do_apply(self, ltx):
        C = self.C
        header = ltx.get_header()
        b = self.body
        src_id = self.source_account_id()
        # reserve for claimants is a sponsored reserve (reference:
        # CreateClaimableBalanceOpFrame — createEntryWithPossibleSponsorship;
        # the entry has no owner account, so only numSponsoring moves).
        # With an active sandwich for the source, the sandwich sponsor takes
        # it; otherwise the source sponsors its own creation.
        sponsor_id = sponsorship.active_sponsor(self.tx, src_id) or src_id
        if sponsor_id != src_id:
            # external sponsor: counters move on the sponsor inside the
            # helper (one unit per claimant; the entry is owner-less); the
            # source is loaded afterwards so its copy cannot clobber a
            # sponsor update
            code = sponsorship.establish_sponsorship(
                ltx, header, sponsor_id, None, len(b.claimants))
            bad = self.sponsorship_error(
                code, C.CREATE_CLAIMABLE_BALANCE_LOW_RESERVE)
            if bad is not None:
                return bad
        src_e = load_account(ltx, src_id)
        src = src_e.data.value
        if sponsor_id == src_id:
            if not utils.add_num_sponsoring(header, src, len(b.claimants)):
                return self.result(C.CREATE_CLAIMABLE_BALANCE_LOW_RESERVE)
        if b.asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            if not add_balance(src, -b.amount, header):
                return self.result(C.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)
        elif not is_issuer(src_id, b.asset):
            tl_e = load_trustline(ltx, src_id, b.asset)
            if tl_e is None:
                return self.result(C.CREATE_CLAIMABLE_BALANCE_NO_TRUST)
            tl = tl_e.data.value
            if not is_authorized(tl):
                return self.result(C.CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
            if not add_trustline_balance(tl, -b.amount):
                return self.result(C.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)
            tl_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(tl_e)
        bid = self.balance_id(ltx)
        # clawback flag propagates from issuer trustline/source account
        flags = 0
        if b.asset.switch != X.AssetType.ASSET_TYPE_NATIVE \
                and not is_issuer(src_id, b.asset):
            tl_probe = load_trustline(ltx, src_id, b.asset)
            if tl_probe is not None and (
                    tl_probe.data.value.flags
                    & X.TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG):
                flags = X.ClaimableBalanceFlags.CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG
        entry = X.ClaimableBalanceEntry(
            balanceID=bid, claimants=list(b.claimants), asset=b.asset,
            amount=b.amount,
            ext=(X.ClaimableBalanceEntryExt.v1(
                    X.ClaimableBalanceEntryExtensionV1(flags=flags))
                 if flags else X.ClaimableBalanceEntryExt.v0()))
        ltx.update(src_e)
        ltx.create(X.LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=X.LedgerEntryData.claimableBalance(entry),
            ext=X.LedgerEntryExt.v1(X.LedgerEntryExtensionV1(
                sponsoringID=sponsor_id,
                ext=X.LedgerEntryExtensionV1Ext.v0()))))
        return self.result(C.CREATE_CLAIMABLE_BALANCE_SUCCESS, bid)


def _predicate_valid(pred: X.ClaimPredicate, depth: int = 0) -> bool:
    if depth > 4:
        return False
    PT = X.ClaimPredicateType
    if pred.switch == PT.CLAIM_PREDICATE_AND or pred.switch == PT.CLAIM_PREDICATE_OR:
        if len(pred.value) != 2:
            return False
        return all(_predicate_valid(p, depth + 1) for p in pred.value)
    if pred.switch == PT.CLAIM_PREDICATE_NOT:
        return pred.value is not None and _predicate_valid(pred.value, depth + 1)
    if pred.switch == PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        return pred.value >= 0
    if pred.switch == PT.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        return pred.value >= 0
    return True


def predicate_satisfied(pred: X.ClaimPredicate, close_time: int,
                        created_time: int) -> bool:
    PT = X.ClaimPredicateType
    if pred.switch == PT.CLAIM_PREDICATE_UNCONDITIONAL:
        return True
    if pred.switch == PT.CLAIM_PREDICATE_AND:
        return all(predicate_satisfied(p, close_time, created_time)
                   for p in pred.value)
    if pred.switch == PT.CLAIM_PREDICATE_OR:
        return any(predicate_satisfied(p, close_time, created_time)
                   for p in pred.value)
    if pred.switch == PT.CLAIM_PREDICATE_NOT:
        return not predicate_satisfied(pred.value, close_time, created_time)
    if pred.switch == PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        return close_time < pred.value
    if pred.switch == PT.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        return close_time < created_time + pred.value
    return False


def _release_claimable_balance_reserve(ltx, cb_entry: X.LedgerEntry,
                                       header) -> None:
    """Refund the sponsor's numSponsoring when a claimable balance leaves
    the ledger (reference: removeEntryWithPossibleSponsorship)."""
    if cb_entry.ext.switch != 1 or cb_entry.ext.value.sponsoringID is None:
        return
    sp_e = load_account(ltx, cb_entry.ext.value.sponsoringID)
    if sp_e is None:
        return  # unreachable while merge rejects IS_SPONSOR; defensive
    released = utils.add_num_sponsoring(
        header, sp_e.data.value, -len(cb_entry.data.value.claimants))
    if not released:  # decrement below zero: counts were already corrupt
        raise RuntimeError("claimable balance sponsor count underflow")
    sp_e.lastModifiedLedgerSeq = header.ledgerSeq
    ltx.update(sp_e)


class ClaimClaimableBalanceOpFrame(OperationFrame):
    """Reference: src/transactions/ClaimClaimableBalanceOpFrame.cpp."""
    MIN_PROTOCOL_VERSION = 14
    OP_TYPE = OT.CLAIM_CLAIMABLE_BALANCE
    RESULT_CLS = X.ClaimClaimableBalanceResult
    C = X.ClaimClaimableBalanceResultCode

    def do_apply(self, ltx):
        C = self.C
        header = ltx.get_header()
        src_id = self.source_account_id()
        key = cb_key(self.body.balanceID)
        cb_e = ltx.load(key)
        if cb_e is None:
            return self.result(C.CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
        cb = cb_e.data.value
        claimant = next((c for c in cb.claimants
                         if c.value.destination == src_id), None)
        # creation time approximated by entry lastModified ledger's close —
        # we carry absolute predicates only against closeTime (relative
        # predicates resolved at create by the reference; simplification).
        if claimant is None or not predicate_satisfied(
                claimant.value.predicate, header.scpValue.closeTime, 0):
            return self.result(C.CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM)
        if cb.asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            acc_e = load_account(ltx, src_id)
            acc = acc_e.data.value
            if not add_balance(acc, cb.amount):
                return self.result(C.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
            acc_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(acc_e)
        elif not is_issuer(src_id, cb.asset):
            tl_e = load_trustline(ltx, src_id, cb.asset)
            if tl_e is None:
                return self.result(C.CLAIM_CLAIMABLE_BALANCE_NO_TRUST)
            tl = tl_e.data.value
            if not is_authorized(tl):
                return self.result(C.CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
            if not add_trustline_balance(tl, cb.amount):
                return self.result(C.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
            tl_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(tl_e)
        _release_claimable_balance_reserve(ltx, cb_e, header)
        ltx.erase(key)
        return self.success()


class ClawbackOpFrame(OperationFrame):
    """Reference: src/transactions/ClawbackOpFrame.cpp."""
    MIN_PROTOCOL_VERSION = 17
    OP_TYPE = OT.CLAWBACK
    RESULT_CLS = X.ClawbackResult
    C = X.ClawbackResultCode

    def do_check_valid(self, ltx):
        if self.body.amount <= 0 or not asset_valid(self.body.asset):
            return self.result(self.C.CLAWBACK_MALFORMED)
        if not is_issuer(self.source_account_id(), self.body.asset):
            return self.result(self.C.CLAWBACK_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        header = ltx.get_header()
        from_id = X.muxed_to_account_id(self.body.from_)
        tl_e = load_trustline(ltx, from_id, self.body.asset)
        if tl_e is None:
            return self.result(C.CLAWBACK_NO_TRUST)
        tl = tl_e.data.value
        if not (tl.flags & X.TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG):
            return self.result(C.CLAWBACK_NOT_CLAWBACK_ENABLED)
        if not add_trustline_balance(tl, -self.body.amount):
            return self.result(C.CLAWBACK_UNDERFUNDED)
        tl_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(tl_e)
        return self.success()


class ClawbackClaimableBalanceOpFrame(OperationFrame):
    """Reference: src/transactions/ClawbackClaimableBalanceOpFrame.cpp."""
    MIN_PROTOCOL_VERSION = 17
    OP_TYPE = OT.CLAWBACK_CLAIMABLE_BALANCE
    RESULT_CLS = X.ClawbackClaimableBalanceResult
    C = X.ClawbackClaimableBalanceResultCode

    def do_apply(self, ltx):
        C = self.C
        key = cb_key(self.body.balanceID)
        cb_e = ltx.load(key)
        if cb_e is None:
            return self.result(C.CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
        cb = cb_e.data.value
        if not is_issuer(self.source_account_id(), cb.asset):
            return self.result(C.CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER)
        flags = cb.ext.value.flags if cb.ext.switch == 1 else 0
        if not (flags & X.ClaimableBalanceFlags.CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG):
            return self.result(C.CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED)
        _release_claimable_balance_reserve(ltx, cb_e, ltx.get_header())
        ltx.erase(key)
        return self.success()


class SetTrustLineFlagsOpFrame(OperationFrame):
    """Reference: src/transactions/SetTrustLineFlagsOpFrame.cpp. LOW."""
    MIN_PROTOCOL_VERSION = 17
    OP_TYPE = OT.SET_TRUST_LINE_FLAGS
    RESULT_CLS = X.SetTrustLineFlagsResult
    C = X.SetTrustLineFlagsResultCode

    def threshold_level(self):
        return THRESHOLD_LOW

    def do_check_valid(self, ltx):
        b = self.body
        C = self.C
        if not asset_valid(b.asset) or b.asset.switch == X.AssetType.ASSET_TYPE_NATIVE:
            return self.result(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if not is_issuer(self.source_account_id(), b.asset):
            return self.result(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if b.trustor == self.source_account_id():
            return self.result(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if b.setFlags & b.clearFlags:
            return self.result(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        auth_mask = (X.TrustLineFlags.AUTHORIZED_FLAG
                     | X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG
                     | X.TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG)
        if (b.setFlags | b.clearFlags) & ~auth_mask:
            return self.result(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if b.setFlags & X.TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG:
            return self.result(C.SET_TRUST_LINE_FLAGS_MALFORMED)  # can only clear
        if (b.setFlags & X.TrustLineFlags.AUTHORIZED_FLAG) and \
                (b.setFlags & X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG):
            return self.result(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        header = ltx.get_header()
        src_e = load_account(ltx, self.source_account_id())
        src = src_e.data.value
        b = self.body
        revoking = (b.clearFlags & (X.TrustLineFlags.AUTHORIZED_FLAG
                    | X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)) != 0
        if revoking and not (src.flags & X.AccountFlags.AUTH_REVOCABLE_FLAG):
            return self.result(C.SET_TRUST_LINE_FLAGS_CANT_REVOKE)
        tl_e = load_trustline(ltx, b.trustor, b.asset)
        if tl_e is None:
            return self.result(C.SET_TRUST_LINE_FLAGS_NO_TRUST_LINE)
        tl = tl_e.data.value
        new_flags = (tl.flags & ~b.clearFlags) | b.setFlags
        auth = new_flags & (X.TrustLineFlags.AUTHORIZED_FLAG
                            | X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)
        if auth == (X.TrustLineFlags.AUTHORIZED_FLAG
                    | X.TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG):
            return self.result(C.SET_TRUST_LINE_FLAGS_INVALID_STATE)
        tl.flags = new_flags
        tl_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(tl_e)
        return self.success()


class BeginSponsoringFutureReservesOpFrame(OperationFrame):
    """Reference: src/transactions/BeginSponsoringFutureReservesOpFrame.cpp.
    Opens a sandwich: until the sponsored account's
    EndSponsoringFutureReserves, every reserve created FOR that account
    (entries via create_entry_with_possible_sponsorship, signers via
    establish_signer_sponsorship) is sponsored by this op's source."""
    MIN_PROTOCOL_VERSION = 14
    OP_TYPE = OT.BEGIN_SPONSORING_FUTURE_RESERVES
    RESULT_CLS = X.BeginSponsoringFutureReservesResult
    C = X.BeginSponsoringFutureReservesResultCode

    def do_check_valid(self, ltx):
        if self.body.sponsoredID == self.source_account_id():
            return self.result(
                self.C.BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        C = self.C
        ctx = _sponsorship_ctx(self.tx)
        sponsored = self.body.sponsoredID.to_xdr()
        sponsor = self.source_account_id().to_xdr()
        if sponsored in ctx:
            return self.result(C.BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED)
        # RECURSIVE guards (reference: no sponsorship chains): the sponsor
        # must not itself be inside a sandwich, and the sponsored account
        # must not currently be sponsoring someone.  A sponsor MAY open
        # several concurrent sandwiches for different accounts.
        if sponsor in ctx:
            return self.result(C.BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE)
        for sponsor_of in ctx.values():
            if sponsor_of == sponsored:
                return self.result(C.BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE)
        ctx[sponsored] = sponsor
        return self.success()


class EndSponsoringFutureReservesOpFrame(OperationFrame):
    MIN_PROTOCOL_VERSION = 14
    OP_TYPE = OT.END_SPONSORING_FUTURE_RESERVES
    RESULT_CLS = X.EndSponsoringFutureReservesResult
    C = X.EndSponsoringFutureReservesResultCode

    def do_apply(self, ltx):
        ctx = _sponsorship_ctx(self.tx)
        me = self.source_account_id().to_xdr()
        if me not in ctx:
            return self.result(
                self.C.END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED)
        del ctx[me]
        return self.success()


class RevokeSponsorshipOpFrame(OperationFrame):
    """Reference: src/transactions/RevokeSponsorshipOpFrame.cpp —
    updateLedgerEntrySponsorship / updateSignerSponsorship.

    Semantics (CAP-33): the op source must be the entry's CURRENT sponsor
    (when sponsored) or its owner (when not).  The NEW sponsor is the
    active sandwich sponsor of the op source, if any:
      old=None, new=None  -> no-op SUCCESS
      old=None, new=S     -> establish (owner numSponsored+, S numSponsoring+)
      old=S1,  new=None   -> remove: reserve returns to the owner, which
                             must afford it (LOW_RESERVE); claimable
                             balances have no owner -> ONLY_TRANSFERABLE
      old=S1,  new=S2     -> transfer (S1 releases, S2 takes w/ checks)
    The canonical transfer recipe is therefore: S2 begins a sandwich FOR S1
    (the current sponsor), S1 runs RevokeSponsorship, S1 ends it."""
    MIN_PROTOCOL_VERSION = 14
    OP_TYPE = OT.REVOKE_SPONSORSHIP
    RESULT_CLS = X.RevokeSponsorshipResult
    C = X.RevokeSponsorshipResultCode

    _SPONSORABLE = (X.LedgerEntryType.ACCOUNT, X.LedgerEntryType.TRUSTLINE,
                    X.LedgerEntryType.OFFER, X.LedgerEntryType.DATA,
                    X.LedgerEntryType.CLAIMABLE_BALANCE)

    @staticmethod
    def _owner_of(key: X.LedgerKey):
        t = key.switch
        if t == X.LedgerEntryType.ACCOUNT:
            return key.value.accountID
        if t in (X.LedgerEntryType.TRUSTLINE, X.LedgerEntryType.DATA):
            return key.value.accountID
        if t == X.LedgerEntryType.OFFER:
            return key.value.sellerID
        return None  # claimable balance: owner-less reserve

    def do_apply(self, ltx):
        C = self.C
        header = ltx.get_header()
        src = self.source_account_id()
        new_sponsor = sponsorship.active_sponsor(self.tx, src)
        arm = self.op.body.value
        if arm.switch == X.RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY:
            key = arm.value
            if key.switch not in self._SPONSORABLE:
                return self.result(C.REVOKE_SPONSORSHIP_MALFORMED)
            entry = ltx.load(key)
            if entry is None:
                return self.result(C.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
            owner_id = self._owner_of(key)
            old_sponsor = sponsorship.entry_sponsor(entry)
            if new_sponsor is not None and new_sponsor == owner_id:
                # transferring to the owner == the owner reclaiming its own
                # reserve: a removal, never a self-sponsorship record
                new_sponsor = None
            if old_sponsor is not None:
                if src != old_sponsor:
                    return self.result(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)
            elif owner_id is None or src != owner_id:
                return self.result(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)
            if old_sponsor == new_sponsor or \
                    (old_sponsor is None and new_sponsor is None):
                return self.success()
            mult = sponsorship.compute_multiplier(entry)
            # the owner's account entry, when the owner is not the entry
            # itself (an ACCOUNT key's owner IS the entry)
            own_is_entry = key.switch == X.LedgerEntryType.ACCOUNT
            owner_e = entry if own_is_entry else (
                load_account(ltx, owner_id) if owner_id is not None else None)
            if old_sponsor is not None:
                if new_sponsor is None and owner_id is None:
                    return self.result(C.REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE)
                if new_sponsor is None:
                    owner = owner_e.data.value
                    if not sponsorship.owner_can_afford(header, owner, mult):
                        return self.result(C.REVOKE_SPONSORSHIP_LOW_RESERVE)
                sponsorship.release_entry_sponsorship(
                    ltx, header, entry, owner_e)
                entry.ext = X.LedgerEntryExt.v0()
            if new_sponsor is not None:
                code = sponsorship.establish_entry_sponsorship(
                    ltx, header, entry, new_sponsor, owner_e)
                bad = self.sponsorship_error(
                    code, C.REVOKE_SPONSORSHIP_LOW_RESERVE)
                if bad is not None:
                    return bad
            entry.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(entry)
            if owner_e is not None and not own_is_entry:
                owner_e.lastModifiedLedgerSeq = header.ledgerSeq
                ltx.update(owner_e)
            return self.success()

        # SIGNER arm
        acc_id = arm.value.accountID
        signer_key = arm.value.signerKey
        acc_e = load_account(ltx, acc_id)
        if acc_e is None:
            return self.result(C.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
        acc = acc_e.data.value
        idx = next((i for i, s in enumerate(acc.signers)
                    if s.key == signer_key), None)
        if idx is None:
            return self.result(C.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
        old_sponsor = sponsorship.signer_sponsor(acc, idx)
        if new_sponsor is not None and new_sponsor == acc_id:
            new_sponsor = None  # owner reclaiming its own reserve
        if old_sponsor is not None:
            if src != old_sponsor:
                return self.result(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)
        elif src != acc_id:
            return self.result(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)
        if old_sponsor == new_sponsor or \
                (old_sponsor is None and new_sponsor is None):
            return self.success()
        if old_sponsor is not None:
            if new_sponsor is None and not sponsorship.owner_can_afford(
                    header, acc, 1):
                return self.result(C.REVOKE_SPONSORSHIP_LOW_RESERVE)
            sponsorship.release_signer_sponsorship(
                ltx, header, old_sponsor, acc_e)
        if new_sponsor is not None:
            code = sponsorship.establish_signer_sponsorship(
                ltx, header, new_sponsor, acc_e)
            bad = self.sponsorship_error(
                code, C.REVOKE_SPONSORSHIP_LOW_RESERVE)
            if bad is not None:
                return bad
        ids = sponsorship._aligned_sponsoring_ids(acc)
        ids[idx] = new_sponsor
        utils._acc_ext_v2(acc).signerSponsoringIDs = ids
        acc_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(acc_e)
        return self.success()


def _sponsorship_ctx(tx_frame) -> dict:
    ctx = getattr(tx_frame, "_sponsorship_ctx", None)
    if ctx is None:
        ctx = {}
        tx_frame._sponsorship_ctx = ctx
    return ctx


_OP_CLASSES = {
    OT.CREATE_ACCOUNT: CreateAccountOpFrame,
    OT.PAYMENT: PaymentOpFrame,
    OT.MANAGE_DATA: ManageDataOpFrame,
    OT.BUMP_SEQUENCE: BumpSequenceOpFrame,
    OT.SET_OPTIONS: SetOptionsOpFrame,
    OT.CHANGE_TRUST: ChangeTrustOpFrame,
    OT.ALLOW_TRUST: AllowTrustOpFrame,
    OT.ACCOUNT_MERGE: AccountMergeOpFrame,
    OT.INFLATION: InflationOpFrame,
    OT.CREATE_CLAIMABLE_BALANCE: CreateClaimableBalanceOpFrame,
    OT.CLAIM_CLAIMABLE_BALANCE: ClaimClaimableBalanceOpFrame,
    OT.CLAWBACK: ClawbackOpFrame,
    OT.CLAWBACK_CLAIMABLE_BALANCE: ClawbackClaimableBalanceOpFrame,
    OT.SET_TRUST_LINE_FLAGS: SetTrustLineFlagsOpFrame,
    OT.BEGIN_SPONSORING_FUTURE_RESERVES: BeginSponsoringFutureReservesOpFrame,
    OT.END_SPONSORING_FUTURE_RESERVES: EndSponsoringFutureReservesOpFrame,
    OT.REVOKE_SPONSORSHIP: RevokeSponsorshipOpFrame,
}


def register_op_class(op_type: OT, cls) -> None:
    """Extension point for op frames defined in other modules
    (offer_exchange.py registers the order-book ops)."""
    _OP_CLASSES[op_type] = cls


# Offer/path-payment/pool frames register themselves on import (bottom of
# module to avoid a circular import — offer_ops subclasses OperationFrame).
from . import offer_ops  # noqa: E402,F401
# Soroban frames likewise (soroban/ops.py subclasses OperationFrame and
# registers InvokeHostFunction / ExtendFootprintTTL / RestoreFootprint).
from ..soroban import ops as _soroban_ops  # noqa: E402,F401
