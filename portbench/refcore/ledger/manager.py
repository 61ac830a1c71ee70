"""LedgerManager: genesis, ledger close, header hash chain.

Reference: src/ledger/LedgerManagerImpl.{h,cpp} — startNewLedger,
valueExternalized/applyLedger, advanceLedgerPointers, plus TxSetFrame
hashing (src/herder/TxSetFrame.cpp — computeTxSetHash,
sortTxsInHashOrder).

Close pipeline per ledger (same phases as the reference):
  1. canonicalize tx set (txs sorted by content hash), hash it
  2. process fees + consume seq nums for every tx
  3. apply each tx (all-or-nothing per tx) collecting results
  4. txSetResultHash, voted upgrades, bucket-list batch (INIT/LIVE/DEAD
     from the LedgerTxn delta), header finalize, hash = SHA256(header XDR)
     chains previous.

The benchmark's plain close: classic transactions over an in-memory
ledger state, serially; nothing else.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .. import xdr as X
from ..crypto.keys import public_key_of_seed
from ..crypto.sha import sha256
from ..bucket.bucket_list import BucketList
from ..herder.upgrades import Upgrades
from ..transactions.frame import TransactionFrame
from .ledger_txn import LedgerTxn, LedgerTxnRoot
from .txset import is_generalized

GENESIS_LEDGER_SEQ = 1
TOTAL_COINS = 100_000_000_000 * 10_000_000  # 100B XLM in stroops
GENESIS_BASE_FEE = 100
GENESIS_BASE_RESERVE = 100_000_000
GENESIS_MAX_TX_SET_SIZE = 100
CURRENT_LEDGER_PROTOCOL_VERSION = 23

SKIP_INTERVALS = (50, 5000, 50000, 500000)


@dataclass
class ClosedLedgerArtifacts:
    """What history publishing needs from each close."""
    header_entry: X.LedgerHeaderHistoryEntry
    tx_entry: X.TransactionHistoryEntry
    result_entry: X.TransactionHistoryResultEntry


class LedgerManager:
    def __init__(self, network_id: bytes):
        self.network_id = network_id
        self.bucket_list = BucketList()
        self.root: Optional[LedgerTxnRoot] = None
        self.lcl_header: Optional[X.LedgerHeader] = None
        self.lcl_hash: Optional[bytes] = None

    # -- genesis ------------------------------------------------------------
    def start_new_ledger(self,
                         protocol_version: int = CURRENT_LEDGER_PROTOCOL_VERSION
                         ) -> None:
        """Create ledger 1 with the network root account (reference:
        LedgerManagerImpl::startNewLedger — root seed is the network id)."""
        root_acc = X.AccountEntry(
            accountID=X.AccountID.ed25519(
                public_key_of_seed(self.network_id).ed25519),
            balance=TOTAL_COINS,
            seqNum=GENESIS_LEDGER_SEQ << 32)
        root_entry = X.LedgerEntry(
            lastModifiedLedgerSeq=GENESIS_LEDGER_SEQ,
            data=X.LedgerEntryData.account(root_acc))

        self.bucket_list.add_batch(GENESIS_LEDGER_SEQ, protocol_version,
                                   [root_entry], [], [])
        header = X.LedgerHeader(
            ledgerVersion=protocol_version,
            previousLedgerHash=b"\x00" * 32,
            scpValue=X.StellarValue(txSetHash=b"\x00" * 32, closeTime=0),
            txSetResultHash=sha256(X.TransactionResultSet(results=[]).to_xdr()),
            bucketListHash=self.bucket_list.hash(),
            ledgerSeq=GENESIS_LEDGER_SEQ,
            totalCoins=TOTAL_COINS, feePool=0, inflationSeq=0, idPool=0,
            baseFee=GENESIS_BASE_FEE, baseReserve=GENESIS_BASE_RESERVE,
            maxTxSetSize=GENESIS_MAX_TX_SET_SIZE,
            skipList=[b"\x00" * 32] * 4)
        self.root = LedgerTxnRoot(header)
        with LedgerTxn(self.root) as ltx:
            ltx.create(root_entry)
            ltx.commit()
        self.lcl_header = header
        self.lcl_hash = sha256(header.to_xdr())

    # -- tx set canonicalization -------------------------------------------
    def make_tx_set(self, frames: Sequence[TransactionFrame]
                    ) -> Tuple[X.TransactionSet, bytes, List[TransactionFrame]]:
        """Sort txs into hash order, build the XDR set and its hash
        (reference: TxSetUtils::sortTxsInHashOrder + computeTxSetHash)."""
        ordered = sorted(frames, key=lambda f: f.content_hash())
        tx_set = X.TransactionSet(
            previousLedgerHash=self.lcl_hash,
            txs=[f.envelope for f in ordered])
        return tx_set, sha256(tx_set.to_xdr()), ordered

    @staticmethod
    def apply_order(frames: Sequence[TransactionFrame]
                    ) -> List[TransactionFrame]:
        """Deterministic APPLY order (reference: TxSetFrame::
        getTxsInApplyOrder / ApplyTxSorter): each source account's txs in
        sequence-number order, interleaved across sources by picking the
        queue head with the smallest content hash."""
        by_src: dict = {}
        for f in frames:
            by_src.setdefault(f.source_account_id().value, []).append(f)
        for q in by_src.values():
            q.sort(key=lambda f: f.seq_num)
        heads = sorted((q[0].content_hash(), src)
                       for src, q in by_src.items())
        out: List[TransactionFrame] = []
        while heads:
            _, src = heapq.heappop(heads)
            q = by_src[src]
            out.append(q.pop(0))
            if q:
                heapq.heappush(heads, (q[0].content_hash(), src))
        return out

    # -- close --------------------------------------------------------------
    def close_ledger(self, frames: Sequence[TransactionFrame],
                     close_time: int,
                     tx_set=None,
                     stellar_value: Optional[X.StellarValue] = None
                     ) -> ClosedLedgerArtifacts:
        """Apply one ledger.  `tx_set` is the set as externalized (legacy
        or generalized; built from `frames` when None); `stellar_value`
        is the externalized consensus value, whose close time and voted
        upgrades it carries (upgrades apply after the tx phase —
        reference: LedgerManagerImpl::applyLedger → Upgrades::applyTo)."""
        if tx_set is None:
            tx_set, tx_set_hash, _ = self.make_tx_set(frames)
        else:
            tx_set_hash = sha256(tx_set.to_xdr())
        ordered = self.apply_order(frames)
        if stellar_value is not None:
            if stellar_value.txSetHash != tx_set_hash:
                raise RuntimeError(
                    "externalized value names a different tx set")
            close_time = stellar_value.closeTime

        seq = self.lcl_header.ledgerSeq + 1
        ltx = LedgerTxn(self.root)
        header = ltx.load_header()
        header.ledgerSeq = seq
        header.previousLedgerHash = self.lcl_hash
        header.scpValue = stellar_value if stellar_value is not None else \
            X.StellarValue(txSetHash=tx_set_hash, closeTime=close_time)
        ltx.commit_header(header)

        # phase 1: fees + seq nums for every tx, before any applies
        for f in ordered:
            with LedgerTxn(ltx) as fee_ltx:
                f.process_fee_seq_num(fee_ltx)
                fee_ltx.commit()

        # phase 2: apply, serially
        result_pairs = [X.TransactionResultPair(
            transactionHash=f.content_hash(), result=f.apply(ltx, close_time))
            for f in ordered]
        result_set = X.TransactionResultSet(results=result_pairs)
        header = ltx.load_header()
        header.txSetResultHash = sha256(result_set.to_xdr())
        if stellar_value is not None:
            for up in stellar_value.upgrades:
                Upgrades.apply_to_checked(up, header)
        ltx.commit_header(header)

        # split the delta into INIT/LIVE/DEAD against the pre-close state;
        # lastModified is stamped at the top-level commit
        delta = ltx.delta()
        init_entries, live_entries, dead_keys = [], [], []
        for kb, entry in delta.items():
            pre = self.root.get_entry(kb)
            if entry is None:
                if pre is not None:
                    dead_keys.append(X.LedgerKey.from_xdr(kb))
            elif pre is None:
                entry.lastModifiedLedgerSeq = seq
                init_entries.append(entry)
            else:
                entry.lastModifiedLedgerSeq = seq
                live_entries.append(entry)

        self.bucket_list.add_batch(seq, header.ledgerVersion,
                                   init_entries, live_entries, dead_keys)
        header = ltx.load_header()
        header.bucketListHash = self.bucket_list.hash()
        self._update_skip_list(header)
        ltx.commit_header(header)
        ltx.commit()

        self.lcl_header = self.root.get_header()
        self.lcl_hash = sha256(self.lcl_header.to_xdr())
        header_entry = X.LedgerHeaderHistoryEntry(
            hash=self.lcl_hash, header=self.lcl_header)
        if is_generalized(tx_set):
            # a generalized set rides in the history entry's ext v1, the
            # legacy field carrying an empty classic set
            tx_entry = X.TransactionHistoryEntry(
                ledgerSeq=seq, txSet=X.TransactionSet(
                    previousLedgerHash=tx_set.value.previousLedgerHash,
                    txs=[]),
                ext=X.TransactionHistoryEntryExt.generalizedTxSet(tx_set))
        else:
            tx_entry = X.TransactionHistoryEntry(ledgerSeq=seq, txSet=tx_set)
        result_entry = X.TransactionHistoryResultEntry(
            ledgerSeq=seq, txResultSet=result_set)
        return ClosedLedgerArtifacts(header_entry, tx_entry, result_entry)

    def _update_skip_list(self, header: X.LedgerHeader) -> None:
        """Rotate the 4 skip hashes at their intervals (reference:
        LedgerHeaderUtils / updateSkipList in LedgerManagerImpl)."""
        sl = list(header.skipList)
        for i, interval in enumerate(SKIP_INTERVALS):
            if header.ledgerSeq % interval == 0:
                sl[i] = header.previousLedgerHash
        header.skipList = sl
