"""Operation frames: per-op checkValid + doApply, for the operations the
benchmark's traffic sends: CreateAccount and native Payment.

Reference: src/transactions/OperationFrame.{h,cpp} (dispatch, thresholds,
source auth), CreateAccountOpFrame.cpp and PaymentOpFrame.cpp.  Any other
operation, or a payment in another asset, raises: the benchmark never
sends one.
"""

from __future__ import annotations

from typing import Optional

from .. import xdr as X
from ..ledger.ledger_txn import LedgerTxn
from . import utils
from .signature_checker import SignatureChecker
from .utils import THRESHOLD_MED, add_balance, load_account

OT = X.OperationType
ORC = X.OperationResultCode


def make_op_frame(tx_frame, index: int, op: X.Operation) -> "OperationFrame":
    cls = _OP_CLASSES.get(op.body.switch)
    if cls is None:
        raise NotImplementedError(
            f"the reference closes no {op.body.switch.name} operation")
    return cls(tx_frame, index, op)


def _inner(op_type: OT, result_union_cls, code, value=None) -> X.OperationResult:
    res = result_union_cls(code, value)
    return X.OperationResult.tr(X.OperationResultTr(op_type, res))


class OperationFrame:
    OP_TYPE: OT = None
    RESULT_CLS = None

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


# --------------------------------------------------------------------------

class CreateAccountOpFrame(OperationFrame):
    """Reference: src/transactions/CreateAccountOpFrame.cpp (no sponsoring
    sandwich: the traffic holds none)."""
    OP_TYPE = OT.CREATE_ACCOUNT
    RESULT_CLS = X.CreateAccountResult
    C = X.CreateAccountResultCode

    def do_check_valid(self, ltx):
        if self.body.startingBalance < 0:
            return self.result(self.C.CREATE_ACCOUNT_MALFORMED)
        if self.body.destination == self.source_account_id():
            return self.result(self.C.CREATE_ACCOUNT_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        header = ltx.get_header()
        dest_key = utils.account_key(self.body.destination)
        if ltx.exists(dest_key):
            return self.result(self.C.CREATE_ACCOUNT_ALREADY_EXIST)
        if self.body.startingBalance < 2 * header.baseReserve:
            return self.result(self.C.CREATE_ACCOUNT_LOW_RESERVE)
        src_e = load_account(ltx, self.source_account_id())
        if not add_balance(src_e.data.value, -self.body.startingBalance,
                           header):
            return self.result(self.C.CREATE_ACCOUNT_UNDERFUNDED)
        ltx.update(src_e)
        ltx.create(X.LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=X.LedgerEntryData.account(X.AccountEntry(
                accountID=self.body.destination,
                balance=self.body.startingBalance,
                seqNum=header.ledgerSeq << 32))))
        return self.success()


class PaymentOpFrame(OperationFrame):
    """Reference: src/transactions/PaymentOpFrame.cpp, native asset."""
    OP_TYPE = OT.PAYMENT
    RESULT_CLS = X.PaymentResult
    C = X.PaymentResultCode

    def do_check_valid(self, ltx):
        if self.body.asset.switch != X.AssetType.ASSET_TYPE_NATIVE:
            raise NotImplementedError("the reference pays only lumens")
        if self.body.amount <= 0:
            return self.result(self.C.PAYMENT_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        header = ltx.get_header()
        amount = self.body.amount
        src_id = self.source_account_id()
        dest_id = X.muxed_to_account_id(self.body.destination)
        dest_e = load_account(ltx, dest_id)
        if dest_e is None:
            return self.result(self.C.PAYMENT_NO_DESTINATION)
        src_e = load_account(ltx, src_id)
        if src_id == dest_id:
            return self.success()
        if not add_balance(src_e.data.value, -amount, header):
            return self.result(self.C.PAYMENT_UNDERFUNDED)
        if not add_balance(dest_e.data.value, amount):
            return self.result(self.C.PAYMENT_LINE_FULL)
        src_e.lastModifiedLedgerSeq = header.ledgerSeq
        dest_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(src_e)
        ltx.update(dest_e)
        return self.success()


_OP_CLASSES = {
    OT.CREATE_ACCOUNT: CreateAccountOpFrame,
    OT.PAYMENT: PaymentOpFrame,
}
