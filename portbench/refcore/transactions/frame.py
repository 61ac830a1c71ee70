"""TransactionFrame: validation, fee/seq processing, and apply.

Reference: src/transactions/TransactionFrame.{h,cpp}.  Protocol level:
current (23) classic semantics, for the benchmark's traffic: v0 and v1
envelopes (no fee bumps), no sponsorship, no Soroban.

Apply pipeline (mirrors §3.2 of SURVEY.md):
  process_fee_seq_num()  — charge fee, consume seqNum (before any op runs)
  apply()                — signature checks, per-op checkValid+doApply inside
                           a nested LedgerTxn, all-or-nothing rollback
"""

from __future__ import annotations

from typing import List, Optional

from .. import xdr as X
from ..crypto.sha import sha256
from ..ledger.ledger_txn import LedgerTxn
from .signature_checker import SignatureChecker
from . import utils
from .utils import THRESHOLD_LOW, load_account

MAX_SEQ_NUM = 2 ** 63 - 1

class TransactionFrame:
    """Wraps a TransactionEnvelope (v0 normalized to v1 view)."""

    def __init__(self, network_id: bytes, envelope: X.TransactionEnvelope):
        if envelope.switch == X.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            raise NotImplementedError("the reference closes no fee bumps")
        self.network_id = network_id
        self.envelope = envelope
        self._hash: Optional[bytes] = None
        self._src_id: Optional[X.AccountID] = None

    # -- wire/creation ------------------------------------------------------
    @staticmethod
    def make_from_wire(network_id: bytes,
                       envelope: X.TransactionEnvelope) -> "TransactionFrame":
        return TransactionFrame(network_id, envelope)

    # -- views over v0/v1 ---------------------------------------------------
    @property
    def is_v0(self) -> bool:
        return self.envelope.switch == X.EnvelopeType.ENVELOPE_TYPE_TX_V0

    @property
    def tx(self):
        return self.envelope.value.tx

    @property
    def signatures(self) -> List[X.DecoratedSignature]:
        return self.envelope.value.signatures

    def source_account_id(self) -> X.AccountID:
        # memoized like _hash: called several times per apply (fee, seq,
        # signature, op phases) and the envelope is immutable once framed
        if self._src_id is None:
            if self.is_v0:
                self._src_id = X.AccountID.ed25519(
                    self.tx.sourceAccountEd25519)
            else:
                self._src_id = X.muxed_to_account_id(self.tx.sourceAccount)
        return self._src_id

    @property
    def operations(self) -> List[X.Operation]:
        return self.tx.operations

    @property
    def fee_bid(self) -> int:
        return self.tx.fee

    @property
    def seq_num(self) -> int:
        return self.tx.seqNum

    def time_bounds(self) -> Optional[X.TimeBounds]:
        if self.is_v0:
            return self.tx.timeBounds
        cond = self.tx.cond
        if cond.switch == X.PreconditionType.PRECOND_TIME:
            return cond.value
        if cond.switch == X.PreconditionType.PRECOND_V2:
            return cond.value.timeBounds
        return None

    # -- hashing ------------------------------------------------------------
    def _v1_tx(self) -> X.Transaction:
        """v0 envelopes hash/sign as the equivalent v1 Transaction
        (reference: TransactionFrame::getSignaturePayload builds the TX
        tagged union for both)."""
        if not self.is_v0:
            return self.tx
        t = self.tx
        return X.Transaction(
            sourceAccount=X.MuxedAccount.ed25519(t.sourceAccountEd25519),
            fee=t.fee, seqNum=t.seqNum,
            cond=(X.Preconditions.timeBounds(t.timeBounds)
                  if t.timeBounds is not None else X.Preconditions.none()),
            memo=t.memo, operations=t.operations)

    def signature_payload(self) -> bytes:
        payload = X.TransactionSignaturePayload(
            networkId=self.network_id,
            taggedTransaction=X.TransactionSignaturePayloadTaggedTransaction.tx(self._v1_tx()))
        return payload.to_xdr()

    def content_hash(self) -> bytes:
        """The transaction hash (ids history entries, preauth signers)."""
        if self._hash is None:
            self._hash = sha256(self.signature_payload())
        return self._hash

    # -- fees ---------------------------------------------------------------
    def num_operations(self) -> int:
        return len(self.operations)

    def min_fee(self, header: X.LedgerHeader) -> int:
        return self.num_operations() * header.baseFee

    def fee_charged(self, header: X.LedgerHeader) -> int:
        """min(bid, numOps*baseFee) — flat per-op pricing."""
        return min(self.fee_bid, self.min_fee(header))

    # -- validation ---------------------------------------------------------
    def _common_valid(self, ltx: LedgerTxn, close_time: int,
                      check_seq: bool) -> Optional[X.TransactionResultCode]:
        C = X.TransactionResultCode
        if self.num_operations() == 0:
            return C.txMISSING_OPERATION
        if self.num_operations() > X.MAX_OPS_PER_TX:
            return C.txMALFORMED
        header = ltx.get_header()
        # version gates run BEFORE validity windows (reference:
        # commonValidPreSeqNum's txNOT_SUPPORTED checks come first)
        cond = self._cond()
        if cond is not None and cond.switch == X.PreconditionType.PRECOND_V2 \
                and header.ledgerVersion < 19:
            return C.txNOT_SUPPORTED  # CAP-21 preconditions are v19+
        if header.ledgerVersion < 13 and self._has_muxed_account():
            return C.txNOT_SUPPORTED  # M-strkeys (CAP-27) are v13+
        tb = self.time_bounds()
        if tb is not None:
            if tb.minTime and close_time < tb.minTime:
                return C.txTOO_EARLY
            if tb.maxTime and close_time > tb.maxTime:
                return C.txTOO_LATE
        if self.fee_bid < self.min_fee(header):
            return C.txINSUFFICIENT_FEE
        if self.seq_num < 0 or self.seq_num > MAX_SEQ_NUM:
            return C.txBAD_SEQ
        acc_entry = ltx.get_entry(
            X.account_key_xdr(self.source_account_id().value))
        if acc_entry is None:
            return C.txNO_ACCOUNT
        acc = acc_entry.data.value
        if check_seq and acc.seqNum + 1 != self.seq_num:
            return C.txBAD_SEQ
        if acc.balance < self.fee_charged(header):
            return C.txINSUFFICIENT_BALANCE
        return None

    def check_valid(self, ltx: LedgerTxn, close_time: int) -> X.TransactionResult:
        """Full validity check without state writes (reference:
        TransactionFrame::checkValid — the tx-queue admission path)."""
        code = self._common_valid(ltx, close_time, check_seq=True)
        if code is None:
            checker = SignatureChecker(
                ltx.get_header().ledgerVersion, self.content_hash(),
                self.signatures)
            ops = self._make_op_frames()
            op_results = []
            ok = True
            for op in ops:
                res = op.check_valid(checker, ltx)
                op_results.append(res)
                if not _op_ok(res):
                    ok = False
            if ok and not self._check_extra_signers(checker):
                code = X.TransactionResultCode.txBAD_AUTH_EXTRA
            elif ok and not checker.check_all_signatures_used():
                code = X.TransactionResultCode.txBAD_AUTH_EXTRA
            elif not ok:
                return _tx_result(self.fee_charged(ltx.get_header()),
                                  X.TransactionResultCode.txFAILED, op_results)
        if code is not None:
            return _tx_result(self.fee_charged(ltx.get_header()), code)
        return _tx_result(self.fee_charged(ltx.get_header()),
                          X.TransactionResultCode.txSUCCESS, None)

    def _cond(self):
        return None if self.is_v0 else self.tx.cond

    def _has_muxed_account(self) -> bool:
        """Any med25519 MuxedAccount in the envelope (reference:
        hasMuxedAccount over tx source, op sources and op muxed
        destinations)."""
        MUX = X.CryptoKeyType.KEY_TYPE_MUXED_ED25519

        def muxed(acct) -> bool:
            return acct is not None and acct.switch == MUX

        if muxed(self.tx.sourceAccount):
            return True
        for op in self.tx.operations:
            if muxed(op.sourceAccount):
                return True
            b = op.body.value
            for attr in ("destination", "from_"):
                v = getattr(b, attr, None)
                if v is not None and hasattr(v, "switch") and muxed(v):
                    return True
        return False

    def _check_extra_signers(self, checker: SignatureChecker) -> bool:
        cond = self._cond()
        if cond is not None and cond.switch == X.PreconditionType.PRECOND_V2:
            for sk in cond.value.extraSigners:
                if not checker.check_signature(
                        [X.Signer(key=sk, weight=1)], 1):
                    return False
        return True

    # -- fee & sequence processing (phase 1 of ledger close) ---------------
    def process_fee_seq_num(self, ltx: LedgerTxn) -> int:
        """Charge the fee into feePool and consume the sequence number.
        Runs for every tx in the set, in set order, before any tx applies
        (reference: LedgerManager::processFeesSeqNums).  A tx whose seqNum
        doesn't chain gets its fee charged but the seq NOT consumed, and
        will report txBAD_SEQ at apply (how bad-seq results appear in
        history).  Returns fee charged."""
        header = ltx.load_header()
        acc_e = load_account(ltx, self.source_account_id())
        if acc_e is None:
            self._bad_seq = True
            return 0
        acc = acc_e.data.value
        fee = min(self.fee_charged(header), max(acc.balance, 0))
        acc.balance -= fee
        if acc.seqNum + 1 == self.seq_num:
            acc.seqNum = self.seq_num
            self._bad_seq = False
        else:
            self._bad_seq = True
        header.feePool += fee
        acc_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(acc_e)
        ltx.commit_header(header)
        return fee

    # -- apply (phase 2) ----------------------------------------------------
    def process_signatures(self, checker: SignatureChecker,
                           ltx: LedgerTxn) -> bool:
        """Tx-level (low-threshold) auth of the fee source."""
        acc_e = load_account(ltx, self.source_account_id())
        if acc_e is None:
            return False
        acc = acc_e.data.value
        return check_account_signature(checker, acc, THRESHOLD_LOW)

    def apply(self, ltx: LedgerTxn, close_time: int) -> X.TransactionResult:
        """All-or-nothing apply in a nested LedgerTxn; fee was already
        charged and stays regardless of outcome."""
        header = ltx.get_header()
        checker = SignatureChecker(header.ledgerVersion, self.content_hash(),
                                   self.signatures)
        fee = self.fee_charged(header)
        C = X.TransactionResultCode

        if getattr(self, "_bad_seq", False):
            return _tx_result(fee, C.txBAD_SEQ)
        inner = LedgerTxn(ltx)
        try:
            code = self._common_valid(inner, close_time, check_seq=False)
            if code is not None and code != C.txBAD_SEQ:
                inner.rollback()
                return _tx_result(fee, code)
            if not self.process_signatures(checker, inner):
                inner.rollback()
                return _tx_result(fee, C.txBAD_AUTH)
            op_results: List[X.OperationResult] = []
            ok = True
            for op in self._make_op_frames():
                res_check = op.check_valid(checker, inner)
                if not _op_ok(res_check):
                    op_results.append(res_check)
                    ok = False
                    continue
                # each op applies in its OWN nested LedgerTxn, rolled back
                # on op failure (reference: applyOperations' per-op ltxOp)
                with LedgerTxn(inner) as op_ltx:
                    res = op.do_apply(op_ltx)
                    if _op_ok(res):
                        op_ltx.commit()
                op_results.append(res)
                if not _op_ok(res):
                    ok = False
            if ok and not self._check_extra_signers(checker):
                inner.rollback()
                return _tx_result(fee, C.txBAD_AUTH_EXTRA)
            if ok and not checker.check_all_signatures_used():
                inner.rollback()
                return _tx_result(fee, C.txBAD_AUTH_EXTRA)
            if not ok:
                inner.rollback()
                return _tx_result(fee, C.txFAILED, op_results)
            inner.commit()
            return _tx_result(fee, C.txSUCCESS, op_results)
        except Exception:
            if inner._open:
                inner.rollback()
            raise

    def _make_op_frames(self):
        from .operations import make_op_frame
        return [make_op_frame(self, i, op)
                for i, op in enumerate(self.operations)]


# -- helpers ---------------------------------------------------------------

def check_account_signature(checker: SignatureChecker, acc: X.AccountEntry,
                            threshold_level: int) -> bool:
    """Master key + signers against the account's threshold at `level`."""
    needed = utils.threshold_level_value(acc, threshold_level)
    signers = list(acc.signers)
    master_weight = utils.threshold_level_value(acc, utils.THRESHOLD_MASTER_WEIGHT)
    if master_weight > 0:
        signers.append(X.Signer(
            key=X.SignerKey.ed25519(acc.accountID.value), weight=master_weight))
    return checker.check_signature(signers, needed)


def _op_ok(res: X.OperationResult) -> bool:
    if res.switch != X.OperationResultCode.opINNER:
        return False
    return res.value.value.switch == 0  # per-op SUCCESS code is always 0


def _tx_result(fee: int, code: X.TransactionResultCode,
               op_results: Optional[List[X.OperationResult]] = None
               ) -> X.TransactionResult:
    C = X.TransactionResultCode
    if code == C.txSUCCESS:
        rr = X.TransactionResultResult.results(op_results or [])
    elif code == C.txFAILED:
        rr = X.TransactionResultResult(C.txFAILED, op_results or [])
    else:
        rr = X.TransactionResultResult(code)
    return X.TransactionResult(feeCharged=fee, result=rr)
