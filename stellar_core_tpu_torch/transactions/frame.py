"""TransactionFrame: validation, fee/seq processing, and apply.

Reference: src/transactions/TransactionFrame.{h,cpp},
FeeBumpTransactionFrame.{h,cpp}, TransactionFrameBase::makeTransactionFromWire.
Protocol level: current (23) classic semantics with version gates at the
reference's introduction boundaries (muxed accounts + fee bumps v13,
CAP-21 preconditions v19; per-op gates via MIN_PROTOCOL_VERSION in
operations.py) — exercised by the for_all_versions test sweep.

Apply pipeline (mirrors §3.2 of SURVEY.md):
  process_fee_seq_num()  — charge fee, consume seqNum (before any op runs)
  apply()                — signature checks, per-op checkValid+doApply inside
                           a nested LedgerTxn, all-or-nothing rollback
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .. import xdr as X
from ..crypto import keys
from ..crypto.sha import sha256
from ..ledger.ledger_txn import LedgerTxn
from .signature_checker import SignatureChecker
from . import utils
from .utils import (THRESHOLD_HIGH, THRESHOLD_LOW, THRESHOLD_MED,
                    load_account)

MAX_SEQ_NUM = 2 ** 63 - 1

SOROBAN_PROTOCOL_VERSION = 20

_SOROBAN_OP_TYPES = frozenset((
    X.OperationType.INVOKE_HOST_FUNCTION,
    X.OperationType.EXTEND_FOOTPRINT_TTL,
    X.OperationType.RESTORE_FOOTPRINT,
))


class TransactionFrame:
    """Wraps a TransactionEnvelope (v0 normalized to v1 view)."""

    def __init__(self, network_id: bytes, envelope: X.TransactionEnvelope):
        if envelope.switch == X.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            raise ValueError("use FeeBumpTransactionFrame")
        self.network_id = network_id
        self.envelope = envelope
        self._hash: Optional[bytes] = None
        self._src_id: Optional[X.AccountID] = None

    # -- wire/creation ------------------------------------------------------
    @staticmethod
    def make_from_wire(network_id: bytes,
                       envelope: X.TransactionEnvelope) -> "TransactionFrameBase":
        if envelope.switch == X.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            return FeeBumpTransactionFrame(network_id, envelope)
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
        if self._hash is None:  # corelint: owned-by=main -- a frame is hashed only on the thread that built or decoded it; other threads get its envelope's bytes
            self._hash = sha256(self.signature_payload())
        return self._hash

    # -- fees ---------------------------------------------------------------
    def num_operations(self) -> int:
        return len(self.operations)

    def min_fee(self, header: X.LedgerHeader) -> int:
        return self.num_operations() * header.baseFee

    def fee_charged(self, header: X.LedgerHeader) -> int:
        """min(bid, numOps*baseFee) — flat per-op pricing.  A Soroban tx
        additionally pays its declared resourceFee in full (this repo's
        model has no refundable-fee split: the declared fee IS the
        charge, reference's non-refundable portion)."""
        fee = min(self.fee_bid, self.min_fee(header))
        sd = self.soroban_data()
        if sd is not None and self.is_soroban():
            fee = min(self.fee_bid, self.min_fee(header) + int(sd.resourceFee))
        return fee

    # -- Soroban views ------------------------------------------------------
    def soroban_data(self) -> Optional[X.SorobanTransactionData]:
        """The tx ext's SorobanTransactionData, or None for classic txs."""
        if self.is_v0:
            return None
        ext = self.tx.ext
        return ext.value if ext.switch == 1 else None

    def is_soroban(self) -> bool:
        return any(op.body.switch in _SOROBAN_OP_TYPES
                   for op in self.operations)

    def _soroban_valid(self, header: X.LedgerHeader
                       ) -> Optional[X.TransactionResultCode]:
        """Soroban envelope shape + declared-resource validation
        (reference: TransactionFrame::XDRProvidesValidFee +
        checkSorobanResourceAndSetError)."""
        C = X.TransactionResultCode
        sd = self.soroban_data()
        if not self.is_soroban():
            # sorobanData on a classic tx is malformed shape
            return C.txMALFORMED if sd is not None else None
        if header.ledgerVersion < SOROBAN_PROTOCOL_VERSION:
            return C.txNOT_SUPPORTED
        if self.num_operations() != 1:
            return C.txMALFORMED      # Soroban txs carry exactly one op
        if sd is None:
            return C.txMALFORMED
        from ..soroban.config import network_config
        net = network_config()
        res = sd.resources
        fp = res.footprint
        ro = [k.to_xdr() for k in fp.readOnly]
        rw = [k.to_xdr() for k in fp.readWrite]
        if len(set(ro)) != len(ro) or len(set(rw)) != len(rw) \
                or set(ro) & set(rw):
            return C.txSOROBAN_INVALID
        if len(ro) + len(rw) > net.tx_max_read_entries \
                or len(rw) > net.tx_max_write_entries:
            return C.txSOROBAN_INVALID
        if int(res.instructions) > net.tx_max_instructions \
                or int(res.readBytes) > net.tx_max_read_bytes \
                or int(res.writeBytes) > net.tx_max_write_bytes:
            return C.txSOROBAN_INVALID
        if int(sd.resourceFee) < net.min_resource_fee(res):
            return C.txSOROBAN_INVALID
        if self.fee_bid < self.min_fee(header) + int(sd.resourceFee):
            return C.txINSUFFICIENT_FEE
        return None

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
        soroban_code = self._soroban_valid(header)
        if soroban_code is not None:
            return soroban_code
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
        self._sponsorship_ctx = {}   # fresh Begin/End sandwich state per apply
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
                # — a mutate-then-fail path (RevokeSponsorship transfer,
                # sponsored CreateAccount UNDERFUNDED) must leave no
                # counter mutations for later ops of the same tx to see
                with LedgerTxn(inner) as op_ltx:
                    res = op.do_apply(op_ltx)
                    if _op_ok(res):
                        op_ltx.commit()
                op_results.append(res)
                if not _op_ok(res):
                    ok = False
            if ok and self._sponsorship_ctx:
                # a BeginSponsoringFutureReserves left unclosed at tx end
                # fails the whole tx (reference: TransactionFrame apply —
                # processPostApply sponsorship check, txBAD_SPONSORSHIP)
                inner.rollback()
                return _tx_result(fee, C.txBAD_SPONSORSHIP)
            if ok and not self._check_extra_signers(checker):
                inner.rollback()
                return _tx_result(fee, C.txBAD_AUTH_EXTRA)
            if ok and not checker.check_all_signatures_used():
                inner.rollback()
                return _tx_result(fee, C.txBAD_AUTH_EXTRA)
            if not ok:
                inner.rollback()
                return _tx_result(fee, C.txFAILED, op_results)
            self._remove_used_one_time_signers(inner)
            inner.commit()
            return _tx_result(fee, C.txSUCCESS, op_results)
        except Exception:
            if inner._open:
                inner.rollback()
            raise

    def _remove_used_one_time_signers(self, ltx: LedgerTxn) -> None:
        """Drop preauth-tx signers matching this tx's hash from every source
        account (reference: removeOneTimeSignerFromAllSourceAccounts),
        releasing the sponsor and keeping signerSponsoringIDs aligned when
        a removed signer was sponsored."""
        from .sponsorship import (record_signer_remove,
                                  release_signer_sponsorship, signer_sponsor)
        ids = {self.source_account_id().value: self.source_account_id()}
        for op in self.operations:
            if op.sourceAccount is not None:
                a = X.muxed_to_account_id(op.sourceAccount)
                ids[a.value] = a
        header = ltx.get_header()
        for acc_id in ids.values():
            acc_e = load_account(ltx, acc_id)
            if acc_e is None:
                continue
            acc = acc_e.data.value
            changed = False
            i = 0
            while i < len(acc.signers):
                s = acc.signers[i]
                if s.key.switch == X.SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX \
                        and s.key.value == self.content_hash():
                    sponsor_id = signer_sponsor(acc, i)
                    acc.signers = acc.signers[:i] + acc.signers[i + 1:]
                    record_signer_remove(acc, i)
                    if sponsor_id is not None:
                        release_signer_sponsorship(ltx, header, sponsor_id,
                                                   acc_e)
                    acc.numSubEntries -= 1
                    changed = True
                else:
                    i += 1
            if changed:
                ltx.update(acc_e)

    def _make_op_frames(self):
        from .operations import make_op_frame
        return [make_op_frame(self, i, op)
                for i, op in enumerate(self.operations)]


TransactionFrameBase = TransactionFrame  # alias; FeeBump subclasses below


class FeeBumpTransactionFrame(TransactionFrame):
    """Reference: src/transactions/FeeBumpTransactionFrame.{h,cpp}.
    Outer envelope charges the fee; the inner v1 tx applies with its own
    signatures.  Result wraps the inner result in txFEE_BUMP_INNER_*."""

    def __init__(self, network_id: bytes, envelope: X.TransactionEnvelope):
        assert envelope.switch == X.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP
        self.network_id = network_id
        self.envelope = envelope
        self._hash = None
        self.inner = TransactionFrame(
            network_id,
            X.TransactionEnvelope.v1(envelope.value.tx.innerTx.value))

    @property
    def tx(self):
        return self.envelope.value.tx  # FeeBumpTransaction

    @property
    def signatures(self):
        return self.envelope.value.signatures

    def source_account_id(self) -> X.AccountID:
        return X.muxed_to_account_id(self.tx.feeSource)

    @property
    def operations(self):
        return self.inner.operations

    @property
    def fee_bid(self) -> int:
        return self.tx.fee

    @property
    def seq_num(self) -> int:
        return self.inner.seq_num

    def time_bounds(self):
        return self.inner.time_bounds()

    def soroban_data(self) -> Optional[X.SorobanTransactionData]:
        return self.inner.soroban_data()

    def signature_payload(self) -> bytes:
        payload = X.TransactionSignaturePayload(
            networkId=self.network_id,
            taggedTransaction=X.TransactionSignaturePayloadTaggedTransaction.feeBump(self.tx))
        return payload.to_xdr()

    def num_operations(self) -> int:
        return self.inner.num_operations() + 1

    def process_fee_seq_num(self, ltx: LedgerTxn) -> int:
        """Fee from the fee source; seqNum consumed on the INNER source."""
        header = ltx.load_header()
        fee_acc_e = load_account(ltx, self.source_account_id())
        if fee_acc_e is None:
            return 0
        fee_acc = fee_acc_e.data.value
        fee = min(self.fee_charged(header), max(fee_acc.balance, 0))
        fee_acc.balance -= fee
        header.feePool += fee
        fee_acc_e.lastModifiedLedgerSeq = header.ledgerSeq
        ltx.update(fee_acc_e)
        inner_acc_e = load_account(ltx, self.inner.source_account_id())
        if inner_acc_e is not None:
            inner_acc_e.data.value.seqNum = self.inner.seq_num
            inner_acc_e.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.update(inner_acc_e)
        ltx.commit_header(header)
        return fee

    def check_valid(self, ltx: LedgerTxn, close_time: int) -> X.TransactionResult:
        C = X.TransactionResultCode
        header = ltx.get_header()
        fee = self.fee_charged(header)
        if header.ledgerVersion < 13:
            # fee bumps arrived in protocol 13 (CAP-15)
            return _tx_result(fee, C.txNOT_SUPPORTED)
        if self.fee_bid < self.min_fee(header):
            return _tx_result(fee, C.txINSUFFICIENT_FEE)
        acc_entry = ltx.get_entry(
            X.account_key_xdr(self.source_account_id().value))
        if acc_entry is None:
            return _tx_result(fee, C.txNO_ACCOUNT)
        checker = SignatureChecker(header.ledgerVersion, self.content_hash(),
                                   self.signatures)
        if not check_account_signature(
                checker, acc_entry.data.value, THRESHOLD_LOW) \
                or not checker.check_all_signatures_used():
            return _tx_result(fee, C.txBAD_AUTH)
        inner_res = self.inner.check_valid(ltx, close_time)
        code = (C.txFEE_BUMP_INNER_SUCCESS
                if inner_res.result.switch == C.txSUCCESS
                else C.txFEE_BUMP_INNER_FAILED)
        return _fee_bump_result(fee, code, self.inner.content_hash(), inner_res)

    def apply(self, ltx: LedgerTxn, close_time: int) -> X.TransactionResult:
        C = X.TransactionResultCode
        header = ltx.get_header()
        fee = self.fee_charged(header)
        if header.ledgerVersion < 13:
            return _tx_result(fee, C.txNOT_SUPPORTED)  # CAP-15 is v13+
        checker = SignatureChecker(header.ledgerVersion, self.content_hash(),
                                   self.signatures)
        acc_e = load_account(ltx, self.source_account_id())
        if acc_e is None or not check_account_signature(
                checker, acc_e.data.value, THRESHOLD_LOW) \
                or not checker.check_all_signatures_used():
            return _fee_bump_result(
                fee, C.txFEE_BUMP_INNER_FAILED, self.inner.content_hash(),
                _tx_result(0, C.txBAD_AUTH))
        inner_res = self.inner.apply(ltx, close_time)
        code = (C.txFEE_BUMP_INNER_SUCCESS
                if inner_res.result.switch == C.txSUCCESS
                else C.txFEE_BUMP_INNER_FAILED)
        return _fee_bump_result(fee, code, self.inner.content_hash(), inner_res)


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


def _fee_bump_result(fee: int, code: X.TransactionResultCode,
                     inner_hash: bytes,
                     inner: X.TransactionResult) -> X.TransactionResult:
    inner_result = X.InnerTransactionResult(
        feeCharged=inner.feeCharged,
        result=X.InnerTransactionResultResult(
            inner.result.switch, inner.result.value))
    pair = X.InnerTransactionResultPair(
        transactionHash=inner_hash, result=inner_result)
    return X.TransactionResult(
        feeCharged=fee,
        result=X.TransactionResultResult(code, pair))
