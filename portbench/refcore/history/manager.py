"""HistoryManager: checkpoint building + publishing.

Reference: src/history/HistoryManagerImpl.{h,cpp} and
src/history/CheckpointBuilder.* (ledger headers, tx sets and results
appended as ledgers close, then written out at each checkpoint boundary
with its bucket files and HAS).
"""

from __future__ import annotations

from typing import List

from .. import xdr as X
from ..ledger.manager import ClosedLedgerArtifacts, LedgerManager
from .archive import (CATEGORY_LEDGER, CATEGORY_RESULTS, CATEGORY_TRANSACTIONS,
                      FileHistoryArchive, HistoryArchiveState, category_path,
                      is_checkpoint_boundary)

_LHHE = X.LedgerHeaderHistoryEntry._xdr_adapter()
_THE = X.TransactionHistoryEntry._xdr_adapter()
_THRE = X.TransactionHistoryResultEntry._xdr_adapter()


class HistoryManager:
    """Accumulates per-ledger artifacts and publishes checkpoints to the
    archives as boundaries are crossed."""

    def __init__(self, ledger_mgr: LedgerManager, network_passphrase: str,
                 archives: List[FileHistoryArchive]):
        self.ledger_mgr = ledger_mgr
        self.network_passphrase = network_passphrase
        self.archives = archives
        self._pending: List[ClosedLedgerArtifacts] = []

    def ledger_closed(self, arts: ClosedLedgerArtifacts) -> None:
        """Call after every close."""
        self._pending.append(arts)
        seq = arts.header_entry.header.ledgerSeq
        if is_checkpoint_boundary(seq):
            self.publish_checkpoint(seq)

    def publish_checkpoint(self, checkpoint_seq: int) -> None:
        """Write ledger/transactions/results streams, bucket files and the
        HAS for this checkpoint to every archive."""
        headers = [a.header_entry for a in self._pending]
        txs = [a.tx_entry for a in self._pending if a.tx_entry.txSet.txs]
        results = [a.result_entry for a in self._pending
                   if a.result_entry.txResultSet.results]
        bl = self.ledger_mgr.bucket_list
        has = HistoryArchiveState.from_bucket_list(
            checkpoint_seq, self.network_passphrase, bl)
        pending = [lvl.next.resolve() for lvl in bl.levels
                   if lvl.next is not None]
        for archive in self.archives:
            archive.put_xdr_file(
                category_path(CATEGORY_LEDGER, checkpoint_seq),
                [_LHHE.pack(h) for h in headers])
            archive.put_xdr_file(
                category_path(CATEGORY_TRANSACTIONS, checkpoint_seq),
                [_THE.pack(t) for t in txs])
            archive.put_xdr_file(
                category_path(CATEGORY_RESULTS, checkpoint_seq),
                [_THRE.pack(r) for r in results])
            for bucket in bl.buckets() + pending:
                if not bucket.is_empty():
                    archive.put_bucket(bucket)
            archive.put_state(has)
        self._pending.clear()
