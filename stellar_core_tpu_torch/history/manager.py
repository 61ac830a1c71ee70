"""HistoryManager: checkpoint building + publishing.

Reference: src/history/HistoryManagerImpl.{h,cpp} (queueCurrentHistory /
publishQueuedHistory), src/history/CheckpointBuilder.* (incremental append of
ledger headers / tx sets / results as ledgers close), src/history/
StateSnapshot.* (what gets written per checkpoint).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import xdr as X
from ..ledger.manager import ClosedLedgerArtifacts, LedgerManager
from ..util import eventlog, tracing
from ..util import logging as slog
from .archive import (CATEGORY_LEDGER, CATEGORY_RESULTS, CATEGORY_TRANSACTIONS,
                      FileHistoryArchive, HistoryArchiveState, category_path,
                      checkpoint_frequency, is_checkpoint_boundary)

log = slog.get("History")

_LHHE = X.LedgerHeaderHistoryEntry._xdr_adapter()
_THE = X.TransactionHistoryEntry._xdr_adapter()
_THRE = X.TransactionHistoryResultEntry._xdr_adapter()


class HistoryManager:
    """Accumulates per-ledger artifacts and publishes checkpoints to the
    configured archives as boundaries are crossed."""

    def __init__(self, ledger_mgr: LedgerManager, network_passphrase: str,
                 archives: Optional[List[FileHistoryArchive]] = None,
                 database=None):
        """With `database`, per-ledger artifacts and the publish queue are
        durable: a node killed mid-checkpoint republishes after restart
        (reference: CheckpointBuilder's on-disk .dirty streams + the
        publishqueue table)."""
        self.ledger_mgr = ledger_mgr
        self.network_passphrase = network_passphrase
        self.archives = archives or []
        self.db = database
        self._pending: List[ClosedLedgerArtifacts] = []
        self.published_checkpoints: List[int] = []
        # first ledger this manager has CONTIGUOUS artifacts from; see
        # resume_from
        self._publish_floor = 0

    def ledger_closed(self, arts: ClosedLedgerArtifacts) -> None:
        """Call after every close (reference: CheckpointBuilder::appendLedger
        + HistoryManager::maybeQueueHistoryCheckpoint)."""
        self._pending.append(arts)
        seq = arts.header_entry.header.ledgerSeq
        if self.db is not None:
            self.db.save_tx_history(seq, _THE.pack(arts.tx_entry),
                                    _THRE.pack(arts.result_entry))
            self.db.commit()
        self.maybe_queue_and_publish(seq)

    def _artifacts_from_db(self, checkpoint_seq: int):
        """Rebuild the checkpoint's streams from durable state (survives a
        crash that wiped the in-memory pending list)."""
        lo = max(2, checkpoint_seq - checkpoint_frequency() + 1)
        headers, txs, results = [], [], []
        for seq in range(lo, checkpoint_seq + 1):
            got = self.db.load_header_by_seq(seq)
            if got is None:
                # publishing a checkpoint with holes would poison every
                # node that later catches up from this archive — fail-stop
                raise RuntimeError(
                    f"header {seq} missing from DB while publishing "
                    f"checkpoint {checkpoint_seq}")
            h, header = got
            headers.append(X.LedgerHeaderHistoryEntry(hash=h, header=header))
        for seq, te, re_ in self.db.load_tx_history(lo, checkpoint_seq):
            tx_entry = _THE.unpack(te)
            result_entry = _THRE.unpack(re_)
            if tx_entry.txSet.txs:
                txs.append(tx_entry)
            if result_entry.txResultSet.results:
                results.append(result_entry)
        return headers, txs, results

    def publish_checkpoint(self, checkpoint_seq: int) -> None:
        """Write ledger/transactions/results streams, bucket files and the
        HAS for this checkpoint to every archive."""
        if self.db is not None:
            headers, txs, results = self._artifacts_from_db(checkpoint_seq)
        else:
            headers = [a.header_entry for a in self._pending]
            txs = [a.tx_entry for a in self._pending
                   if a.tx_entry.txSet.txs]
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
        self.published_checkpoints.append(checkpoint_seq)
        self._pending.clear()
        if self.db is not None:
            self.db.dequeue_publish(checkpoint_seq)
            # retain two checkpoint windows of artifacts + headers (the
            # reference's maintenance keeps a sliding window too)
            keep_from = checkpoint_seq - 2 * checkpoint_frequency()
            self.db.prune_tx_history(keep_from)
            self.db.delete_old_headers(keep_from)
            self.db.commit()
        eventlog.record("History", "INFO", "checkpoint published",
                        checkpoint=checkpoint_seq, headers=len(headers),
                        txs=len(txs))
        tracing.mark_phase("checkpoint-publish", checkpoint_seq,
                           headers=len(headers), txs=len(txs))
        log.info("published checkpoint %d (%d headers, %d tx entries)",
                 checkpoint_seq, len(headers), len(txs))

    def resume_from(self, seq: int) -> None:
        """A node that adopted state from catchup (archive rejoin) has no
        artifacts for the ledgers it skipped — publishing the checkpoint
        window that straddles the adoption would write a stream with
        holes and poison every node that later catches up from this
        archive.  Drop the stale pending list and skip any boundary whose
        window starts before `seq`; healthy peers publish the identical
        bytes for it."""
        self._pending.clear()
        self._publish_floor = seq

    def maybe_queue_and_publish(self, seq: int) -> None:
        """Durable two-step publish: enqueue the boundary, then publish and
        dequeue — a crash between the two republishes at startup
        (reference: queueCurrentHistory + publishQueuedHistory)."""
        boundary = is_checkpoint_boundary(seq)
        if boundary and \
                max(2, seq - checkpoint_frequency() + 1) < self._publish_floor:
            # incomplete window after a catchup adoption (see resume_from)
            self._pending.clear()
            boundary = False
        if self.db is None:
            if boundary:
                self.publish_checkpoint(seq)
            return
        if boundary:
            self.db.queue_publish(seq, "")
            self.db.commit()
        self.publish_queued_history()

    def publish_queued_history(self) -> int:
        """Publish every queued checkpoint (startup recovery path).
        Returns the number published."""
        if self.db is None:
            return 0
        done = 0
        for seq, _state in self.db.publish_queue():
            self.publish_checkpoint(seq)
            done += 1
        return done
