"""LedgerManager: genesis, ledger close, header hash chain.

Reference: src/ledger/LedgerManagerImpl.{h,cpp} — startNewLedger,
valueExternalized/applyLedger (SURVEY.md §3.2 call stack), advanceLedgerPointers,
plus TxSetFrame hashing (src/herder/TxSetFrame.cpp — computeTxSetHash,
sortTxsInHashOrder).

Close pipeline per ledger (same phases as the reference):
  1. canonicalize tx set (txs sorted by content hash), hash it
  2. process fees + consume seq nums for every tx
  3. apply each tx (all-or-nothing per tx) collecting results
  4. txSetResultHash, bucket-list batch (INIT/LIVE/DEAD from the LedgerTxn
     delta), header finalize, hash = SHA256(header XDR) chains previous.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import xdr as X
from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..bucket.bucket_list import BucketList
from ..transactions.frame import TransactionFrame
from ..util import detguard
from ..util import eventlog
from ..util import logging as slog
from ..util import tracing
from ..util.assertions import release_assert
from ..util.metrics import registry as _registry
from .costs import CloseCostLedger
from .ledger_txn import LedgerTxn, LedgerTxnRoot

log = slog.get("Ledger")

GENESIS_LEDGER_SEQ = 1
TOTAL_COINS = 100_000_000_000 * 10_000_000  # 100B XLM in stroops
GENESIS_BASE_FEE = 100
GENESIS_BASE_RESERVE = 100_000_000
GENESIS_MAX_TX_SET_SIZE = 100
CURRENT_LEDGER_PROTOCOL_VERSION = 23

SKIP_INTERVALS = (50, 5000, 50000, 500000)


@dataclass
class ClosedLedgerArtifacts:
    """What history publishing needs from each close (reference: the data
    CheckpointBuilder appends — SURVEY.md §2.1 History publish)."""
    header_entry: X.LedgerHeaderHistoryEntry
    tx_entry: X.TransactionHistoryEntry
    result_entry: X.TransactionHistoryResultEntry


DEFAULT_ENTRY_CACHE_SIZE = 4096   # mirrored by config.BUCKETLISTDB_ENTRY_CACHE_SIZE


def assume_bucket_state(bucket_list, header: X.LedgerHeader,
                        bucket_source, next_source=None,
                        invariant_manager=None, store=None,
                        entry_cache_size: int = DEFAULT_ENTRY_CACHE_SIZE,
                        resident_levels: Optional[int] = None
                        ) -> LedgerTxnRoot:
    """Fill `bucket_list`'s levels from `bucket_source(hex_hash) -> Bucket`
    and build the authoritative root.  In-memory mode derives the entry
    dict newest-first (first record per key wins; DEADENTRY shadows older
    versions); BucketListDB mode (`store` given) persists + indexes the
    buckets instead — the files ARE the store, no dict is materialized.
    Verifies the reassembled list against header.bucketListHash.  Shared
    by restart (loadLastKnownLedger) and catchup state assumption
    (ApplyBucketsWork + BucketApplicator).

    next_source(level) -> Optional[FutureBucket]: the level's pending merge
    (HAS "next", reference: FutureBucket::makeLive, usually built via
    HistoryArchiveState.rehydrate_next) — restoring it is what makes
    post-restore bucket hashes identical to a node that never restarted.
    Entry derivation skips next buckets: their content is older-or-equal to
    what curr/snap already expose."""
    from ..bucket.bucket_list import NUM_LEVELS

    seen: set = set()
    root = None if store is not None else LedgerTxnRoot(header)
    for i in range(NUM_LEVELS):
        for j, attr in ((0, "curr"), (1, "snap")):
            bucket = bucket_source(i * 2 + j)
            if bucket is None:
                raise RuntimeError("missing bucket for level %d %s"
                                   % (i, attr))
            if invariant_manager is not None:
                # localize archive corruption to an entry + message
                # (reference: InvariantManagerImpl::checkOnBucketApply)
                invariant_manager.check_on_bucket_apply(
                    bucket, i, header.ledgerSeq)
            setattr(bucket_list.levels[i], attr, bucket)
            if root is None:
                continue
            for be in bucket.entries:
                if be.switch == X.BucketEntryType.DEADENTRY:
                    seen.add(be.value.to_xdr())
                else:
                    kb = X.ledger_entry_key(be.value).to_xdr()
                    if kb not in seen:
                        seen.add(kb)
                        root._apply_delta({kb: be.value}, None)
        if next_source is not None:
            bucket_list.levels[i].next = next_source(i)
    if bucket_list.hash() != header.bucketListHash:
        raise RuntimeError("assumed bucket list hash != header hash")
    if root is None:
        # BucketListDB: persist + index the assumed buckets, then drop the
        # decoded lists of levels >= the residency depth — the deep levels
        # never stay O(ledger) in memory, even right after catchup
        if bucket_list.store is None:
            from ..bucket.bucket_list import DEFAULT_RESIDENT_LEVELS
            bucket_list.configure_residency(
                store, resident_levels if resident_levels is not None
                else DEFAULT_RESIDENT_LEVELS)
        bucket_list.enforce_residency()
        snap = bucket_list.snapshot(header.ledgerSeq, store=store)
        root = LedgerTxnRoot(header, snapshot=snap,
                             entry_cache_size=entry_cache_size)
    return root


_DEFAULT_INVARIANTS = object()


class LedgerManager:
    # disk-mode GC cadence: every N closes, unreferenced+unpinned bucket
    # files are deleted (content-addressed level-0 files otherwise pile up
    # one per ledger)
    BUCKET_GC_INTERVAL = 8

    def __init__(self, network_id: bytes,
                 invariant_manager=_DEFAULT_INVARIANTS,
                 merge_executor=None, bucket_store=None,
                 entry_cache_size: Optional[int] = None,
                 resident_levels: Optional[int] = None):
        """invariant_manager: an InvariantManager, None to disable, or
        default = all invariants enabled (reference ships them off by
        default; this framework inverts that — fail-stop by default, opt
        out on the hot replay path).

        merge_executor: thread pool for background bucket merges
        (reference: WORKER_THREADS-driven FutureBucket merges).

        bucket_store: a bucket.manager.BucketListStore → BucketListDB mode
        (`in_memory_ledger = false`): the root reads through indexed
        on-disk bucket files with an LRU entry cache of
        `entry_cache_size` entries; None → legacy in-memory dict root.

        resident_levels: BucketListDB residency depth (config
        BUCKET_RESIDENT_LEVELS): levels >= it hold no decoded entries —
        their buckets are served from indexed files and merged by the
        streaming decode-free path."""
        self.network_id = network_id
        self.bucket_list = BucketList(executor=merge_executor)
        self.bucket_store = bucket_store
        self.entry_cache_size = entry_cache_size or DEFAULT_ENTRY_CACHE_SIZE
        if bucket_store is not None:
            from ..bucket.bucket_list import DEFAULT_RESIDENT_LEVELS
            self.bucket_list.configure_residency(
                bucket_store, resident_levels if resident_levels is not None
                else DEFAULT_RESIDENT_LEVELS)
        self.root: Optional[LedgerTxnRoot] = None
        self.lcl_header: Optional[X.LedgerHeader] = None
        self.lcl_hash: Optional[bytes] = None
        if invariant_manager is _DEFAULT_INVARIANTS:
            from ..invariant import InvariantManager
            invariant_manager = InvariantManager()
        self.invariants = invariant_manager
        self.db = None           # database.Database when persistence is on
        self.bucket_dir = None   # bucket.manager.BucketDir
        # observability (reference: METADATA_OUTPUT_STREAM + medida timers)
        self.meta_stream = None  # callable(LedgerCloseMeta) or file-like
        # catchup's native bridge (historywork probes it per checkpoint)
        self.native_bridge = None
        # native live close (ledger/native_close.py): when attached,
        # close_ledger routes through the C engine with differential
        # spot-checks; None = classic Python close
        self.native_closer = None
        # Soroban: footprint-parallel apply of the Soroban
        # phase (serial fallback stays byte-identical); the TTL expiry
        # index drives archival/eviction at close.  None = unknown (state
        # was loaded, rebuild lazily on first Soroban activity); {} =
        # known-empty (fresh chain).
        self.soroban_parallel_apply = True
        self._ttl_expiry: Optional[dict] = {}
        # per-close cost ledger: one CloseCostRecord per
        # sealed ledger, served at /closecosts.  The Python close fills
        # every field; native closes record seq/txs/total and the
        # bucket-side fields (phase splits and cache traffic are engine-
        # internal there and read as 0).
        self.close_costs = CloseCostLedger()
        _registry().weak_gauge("closecost.records.retained",
                               self.close_costs, len)
        self._last_gc_seq = 0
        # injected-regression seam (anomaly proof): > 0 spins
        # the close for this many extra seconds.  Spins on perf_counter,
        # which detguard leaves unpatched, so the throttle is legal
        # inside the guarded close region.
        self.debug_close_throttle_s = 0.0  # corelint: disable=float-discipline -- test-only throttle knob, never ledger state

    # -- genesis ------------------------------------------------------------
    def start_new_ledger(self,
                         protocol_version: int = CURRENT_LEDGER_PROTOCOL_VERSION
                         ) -> None:
        """Create ledger 1 with the network root account (reference:
        LedgerManagerImpl::startNewLedger — root seed is the network id)."""
        root_key = SecretKey(self.network_id)
        root_acc = X.AccountEntry(
            accountID=X.AccountID.ed25519(root_key.public_key.ed25519),
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
        if self.bucket_store is not None:
            # BucketListDB: the bucket list (just fed the root account)
            # IS the store — no dict to seed
            self.root = self._make_disk_root(header)
        else:
            self.root = LedgerTxnRoot(header)
            with LedgerTxn(self.root) as ltx:
                ltx.create(root_entry)
                ltx.commit()
        self.lcl_header = header
        self.lcl_hash = sha256(header.to_xdr())
        log.info("genesis ledger 1 closed, root=%s",
                 root_key.public_key.to_strkey())

    def root_account_secret(self) -> SecretKey:
        return SecretKey(self.network_id)

    # -- BucketListDB snapshot management -----------------------------------
    def _make_disk_root(self, header: X.LedgerHeader) -> LedgerTxnRoot:
        """Fresh disk-backed root over the CURRENT bucket list (genesis /
        native-engine export / rebuilds).  Replaces any previous root's
        snapshot pins.  Deep levels that (re)entered decoded — the native
        export path deserializes every bucket — drop their entry lists
        first."""
        self.bucket_list.enforce_residency()
        snap = self.bucket_list.snapshot(header.ledgerSeq,
                                         store=self.bucket_store)
        if self.root is not None and self.root.disk_backed:
            self.root.release_snapshot()
        return LedgerTxnRoot(header, snapshot=snap,
                             entry_cache_size=self.entry_cache_size)

    def _refresh_snapshot(self, ledger_seq: int) -> None:
        """Swap the root onto a fresh read view after a bucket-list
        mutation (every close's seal phase); the superseded view's file
        pins are released so GC can reclaim its buckets."""
        snap = self.bucket_list.snapshot(ledger_seq, store=self.bucket_store)
        old = self.root.set_snapshot(snap)
        if old is not None:
            old.release()

    def _maybe_gc_buckets(self, ledger_seq: int) -> None:
        """Periodic bucket-file GC (reference: forgetUnreferencedBuckets
        after each close): referenced = the live list's curr/snap/pending
        hashes; snapshot-pinned files survive regardless."""
        if ledger_seq % self.BUCKET_GC_INTERVAL == 0:
            self.bucket_store.gc(self.bucket_list.referenced_hashes())
            self._last_gc_seq = ledger_seq

    def build_root(self, header: X.LedgerHeader,
                   raw_entries) -> LedgerTxnRoot:
        """Root over `header` + the current bucket list, from the native
        engine's exported state.  Disk mode ignores `raw_entries` (the
        just-rebuilt bucket list is the authority — no decode); in-memory
        mode materializes the dict from the (key XDR, entry XDR) pairs."""
        if self.bucket_store is not None:
            return self._make_disk_root(header)
        root = LedgerTxnRoot(header)
        root._entries = {kb: X.LedgerEntry.from_xdr(rec)
                         for kb, rec in raw_entries}
        return root

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

    def make_tx_set_any(self, frames: Sequence[TransactionFrame]):
        """make_tx_set, upgraded: a set containing Soroban txs becomes a
        GeneralizedTransactionSet (classic phase + Soroban phase); a
        pure-classic set keeps the legacy shape (and hash) byte-for-byte."""
        soroban = [f for f in frames if f.is_soroban()]
        if not soroban:
            return self.make_tx_set(frames)
        from ..soroban.txset import build_generalized_tx_set
        classic = [f for f in frames if not f.is_soroban()]
        gts, h = build_generalized_tx_set(self.lcl_hash, classic, soroban)
        ordered = sorted(classic, key=lambda f: f.content_hash()) \
            + sorted(soroban, key=lambda f: f.content_hash())
        return gts, h, ordered

    @staticmethod
    def apply_order(frames: Sequence[TransactionFrame]
                    ) -> List[TransactionFrame]:
        """Deterministic APPLY order (reference: TxSetFrame::
        getTxsInApplyOrder / ApplyTxSorter): each source account's txs in
        sequence-number order — hash order alone would seq-fail all but
        the lowest-seq tx of a multi-tx source — interleaved across
        sources by picking the queue head with the smallest content hash.
        Consensus-critical: live close and catchup replay must agree."""
        import heapq
        by_src: dict = {}
        for f in frames:
            by_src.setdefault(f.source_account_id().value, []).append(f)
        for q in by_src.values():
            q.sort(key=lambda f: f.seq_num)
        # sorted list is a valid heap; content hashes are unique so the
        # pop order is total regardless of dict insertion order
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
                     tx_set: Optional[X.TransactionSet] = None,
                     expected_ledger_hash: Optional[bytes] = None,
                     stellar_value: Optional[X.StellarValue] = None
                     ) -> ClosedLedgerArtifacts:
        """Apply one ledger.  `frames` may arrive unsorted; the canonical
        order is derived.  If expected_ledger_hash is given (catchup replay),
        a mismatch raises — fail-stop, like the reference's hash checks.
        `stellar_value` is the externalized consensus value (carries voted
        upgrades, applied after the tx phase — reference:
        LedgerManagerImpl::applyLedger → Upgrades::applyTo)."""
        release_assert(self.root is not None,
                       "start_new_ledger/load first")
        with detguard.region("ledger-close"):
            if self.native_closer is not None \
                    and expected_ledger_hash is None:
                # live close through the C engine (catchup replay keeps
                # its own bridge: expected_ledger_hash marks that path).
                # The closer owns the ledger.close span — its fallback
                # paths run _close_ledger_python, which opens its own
                return self.native_closer.close_ledger(
                    frames, close_time, tx_set, stellar_value)
            return self._close_ledger_python(
                frames, close_time, tx_set, expected_ledger_hash,
                stellar_value)

    def _close_ledger_python(self, frames: Sequence[TransactionFrame],
                             close_time: int,
                             tx_set: Optional[X.TransactionSet] = None,
                             expected_ledger_hash: Optional[bytes] = None,
                             stellar_value: Optional[X.StellarValue] = None
                             ) -> ClosedLedgerArtifacts:
        """The classic pure-Python close (the oracle the native close
        differentially checks against, and its fallback)."""
        release_assert(self.root is not None,
                       "start_new_ledger/load first")
        with tracing.span("ledger.close",
                          seq=self.lcl_header.ledgerSeq + 1,
                          txs=len(frames)):
            try:
                return self._close_ledger(frames, close_time, tx_set,
                                          expected_ledger_hash, stellar_value)
            except BaseException:
                # a close that dies mid-flight (fail-stop invariant, a bug
                # surfaced by fuzzing) must not leave its LedgerTxn attached
                # to the root — the manager would refuse every later close
                # with "already has an active child" instead of reporting
                # the real error
                child = getattr(self.root, "_child", None)
                if child is not None and getattr(child, "_open", False):
                    child.rollback()
                raise

    # -- native live close ---------------------------------------------------
    def attach_native_close(self, differential: Optional[int] = None
                            ) -> bool:
        """Route live closes through the C engine (ledger/native_close.py).
        Returns False (and stays on Python) when unavailable."""
        from .native_close import NativeLedgerCloser, native_close_available
        if not native_close_available(self):
            return False
        self.native_closer = NativeLedgerCloser(self, differential)
        self.native_closer.activate()
        return True

    def detach_native_close(self) -> None:
        """Move authority back to Python and drop the native closer."""
        if self.native_closer is not None:
            self.native_closer.deactivate()
            self.native_closer = None

    def _close_ledger(self, frames: Sequence[TransactionFrame],
                      close_time: int,
                      tx_set: Optional[X.TransactionSet],
                      expected_ledger_hash: Optional[bytes],
                      stellar_value: Optional[X.StellarValue]
                      ) -> ClosedLedgerArtifacts:
        _t0 = time.perf_counter()
        if tx_set is None:
            tx_set, tx_set_hash, ordered = self.make_tx_set_any(frames)
        else:
            tx_set_hash = sha256(tx_set.to_xdr())
        # phase split: classic applies first, then the Soroban phase —
        # for a pure-classic set this is exactly the legacy apply order
        soroban_frames = [f for f in frames if f.is_soroban()]
        if soroban_frames:
            classic_frames = [f for f in frames if not f.is_soroban()]
            ordered = self.apply_order(classic_frames) \
                + self.apply_order(soroban_frames)
        else:
            ordered = self.apply_order(frames)
        if stellar_value is not None:
            if stellar_value.txSetHash != tx_set_hash:
                # fail-stop: committing a header that names a tx set other
                # than the one applied would corrupt the hash chain
                raise RuntimeError(
                    "externalized value names a different tx set")
            close_time = stellar_value.closeTime

        seq = self.lcl_header.ledgerSeq + 1
        # cost-ledger baselines: entry-cache traffic and
        # resident footprint are reported as per-close deltas; taken
        # before the prefetch so its cache fills count toward this close
        _hits0 = _registry().meter("bucketlistdb.cache.hit").count
        _miss0 = _registry().meter("bucketlistdb.cache.miss").count
        _resident0 = self.bucket_list.decoded_entry_count()
        if self.root.disk_backed and ordered:
            # bulk prefetch the tx set's account entries into the entry
            # cache: one batched, file-order snapshot pass instead of a
            # per-load probe chain each (reference: prefetchClassic
            # before apply)
            keys = set()
            for f in ordered:
                keys.add(X.account_key_xdr(f.source_account_id().value))
                inner = getattr(f, "inner", None)
                if inner is not None:
                    keys.add(X.account_key_xdr(
                        inner.source_account_id().value))
                for op in f.operations:
                    if op.sourceAccount is not None:
                        keys.add(X.account_key_xdr(
                            X.muxed_to_account_id(op.sourceAccount).value))
            self.root.prefetch(keys)
        ltx = LedgerTxn(self.root)
        header = ltx.load_header()
        header.ledgerSeq = seq
        header.previousLedgerHash = self.lcl_hash
        header.scpValue = stellar_value if stellar_value is not None else \
            X.StellarValue(txSetHash=tx_set_hash, closeTime=close_time)
        ltx.commit_header(header)

        # phase 1: fees + seq nums for every tx, before any applies
        _fee_t0 = time.perf_counter()
        with tracing.span("ledger.fee-process"), \
                _registry().timer("ledger.fee.process").time():
            for f in ordered:
                with LedgerTxn(ltx) as fee_ltx:
                    f.process_fee_seq_num(fee_ltx)
                    fee_ltx.commit()
        _fee_s = time.perf_counter() - _fee_t0

        # phase 2: apply — classic serially, then the Soroban phase
        # (footprint-clustered, optionally parallel)
        result_pairs: List[X.TransactionResultPair] = []
        split = len(ordered) - len(soroban_frames) if soroban_frames \
            else len(ordered)
        _apply_t0 = time.perf_counter()
        with tracing.span("ledger.tx-apply"):
            for f in ordered[:split]:
                with tracing.span("tx.apply"):
                    res = f.apply(ltx, close_time)
                result_pairs.append(X.TransactionResultPair(
                    transactionHash=f.content_hash(), result=res))
            if split < len(ordered):
                for f, res in self._apply_soroban_phase(
                        ltx, ordered[split:], close_time, seq):
                    result_pairs.append(X.TransactionResultPair(
                        transactionHash=f.content_hash(), result=res))
        _apply_s = time.perf_counter() - _apply_t0

        # state archival: expired TTLs evict at the close edge (before
        # the delta is split for the bucket list)
        self._evict_expired_ttl(ltx, seq)

        result_set = X.TransactionResultSet(results=result_pairs)
        header = ltx.load_header()
        header.txSetResultHash = sha256(result_set.to_xdr())

        # voted upgrades apply after the tx phase (reference: applyLedger →
        # Upgrades::applyTo, which re-validates and skips-with-log rather
        # than crashing mid-close; skipping is deterministic so live close
        # and catchup replay stay hash-identical)
        if stellar_value is not None and stellar_value.upgrades:
            from ..herder.upgrades import Upgrades
            for up in stellar_value.upgrades:
                Upgrades.apply_to_checked(up, header)
        ltx.commit_header(header)

        # split delta into INIT/LIVE/DEAD vs the pre-close state; stamp
        # lastModified at top-level commit time (reference: LedgerTxn
        # shouldUpdateLastModified at the root commit)
        delta = ltx.delta()
        self._note_soroban_delta(delta)
        pre_entries = {kb: self.root.get_entry(kb) for kb in delta}
        init_entries, live_entries, dead_keys = [], [], []
        for kb, entry in delta.items():  # corelint: disable=iteration-order -- delta is insertion-ordered: serial-equivalent first-write order, load-bearing
            pre = pre_entries[kb]
            if entry is None:
                if pre is not None:
                    dead_keys.append(X.LedgerKey.from_xdr(kb))
            elif pre is None:
                entry.lastModifiedLedgerSeq = seq
                init_entries.append(entry)
            else:
                entry.lastModifiedLedgerSeq = seq
                live_entries.append(entry)

        # pre-bucket invariant phase: a violation here fail-stops with the
        # manager un-torn (neither root store nor bucket list advanced)
        inv_ctx = None
        if self.invariants is not None:
            from ..invariant import LedgerCloseContext
            inv_ctx = LedgerCloseContext(
                pre=pre_entries, post=delta,
                pre_header=self.lcl_header, post_header=ltx.get_header(),
                root_get=self.root.get_entry,
                all_keys=lambda: list(self.root.all_keys()),
                bucket_list=self.bucket_list)
            self.invariants.check_on_ledger_close(inv_ctx,
                                                  needs_buckets=False)

        _seal_t0 = time.perf_counter()
        with tracing.span("ledger.seal"):
            self.bucket_list.add_batch(seq, header.ledgerVersion,
                                       init_entries, live_entries, dead_keys)
            if self.root.disk_backed:
                # the list just mutated: persist+index the changed buckets
                # and swap the root onto the new view; deep levels drop any
                # decoded entry lists (streaming-merge outputs already are
                # disk-resident), then GC reclaims files only old
                # (released) snapshots referenced
                with tracing.span("bucket.snapshot"):
                    self._refresh_snapshot(seq)
                self.bucket_list.enforce_residency()
                self._maybe_gc_buckets(seq)
            header = ltx.load_header()
            header.bucketListHash = self.bucket_list.hash()
            self._update_skip_list(header)
            ltx.commit_header(header)
        _seal_s = time.perf_counter() - _seal_t0

        if inv_ctx is not None:
            # post-bucket phase: a violation means the bucket list is
            # corrupt; the manager must be discarded
            self.invariants.check_on_ledger_close(inv_ctx, needs_buckets=True)
        ltx.commit()

        self.lcl_header = self.root.get_header()
        self.lcl_hash = sha256(self.lcl_header.to_xdr())
        if expected_ledger_hash is not None \
                and self.lcl_hash != expected_ledger_hash:
            raise RuntimeError(
                f"ledger {seq} hash mismatch: got {self.lcl_hash.hex()} "
                f"expected {expected_ledger_hash.hex()}")

        if self.db is not None:
            self._persist_lcl()

        header_entry = X.LedgerHeaderHistoryEntry(
            hash=self.lcl_hash, header=self.lcl_header)
        meta_tx_set = tx_set
        from ..soroban.txset import is_generalized
        if is_generalized(tx_set):
            # history entry: generalized sets ride in ext v1; the legacy
            # txSet field carries an empty classic set (reference:
            # TransactionHistoryEntry.ext.generalizedTxSet)
            meta_tx_set = X.TransactionSet(
                previousLedgerHash=tx_set.value.previousLedgerHash, txs=[])
            tx_entry = X.TransactionHistoryEntry(
                ledgerSeq=seq, txSet=meta_tx_set,
                ext=X.TransactionHistoryEntryExt.generalizedTxSet(tx_set))
        else:
            tx_entry = X.TransactionHistoryEntry(ledgerSeq=seq, txSet=tx_set)
        result_entry = X.TransactionHistoryResultEntry(
            ledgerSeq=seq, txResultSet=result_set)

        if self.debug_close_throttle_s > 0.0:  # corelint: disable=float-discipline -- test-only throttle knob, never ledger state
            # injected-regression seam: spin out the close so the
            # anomaly detector has a real sustained departure to catch
            _spin_until = time.perf_counter() + self.debug_close_throttle_s
            while time.perf_counter() < _spin_until:
                pass

        # registry lookups are NOT cached across the close: /clearmetrics
        # resets metrics in place, but reset_registry() (tests) swaps the
        # whole registry — a cached reference would feed a dead object
        dur_s = time.perf_counter() - _t0
        _registry().timer("ledger.ledger.close").update(dur_s)
        # flight event at the seal edge: the last thing a post-mortem sees
        # from a healthy node is the close it finished
        eventlog.record("Ledger", "INFO", "ledger close sealed",
                        seq=seq, txs=len(ordered),
                        dur_ms=round(dur_s * 1e3, 3),
                        hash=self.lcl_hash.hex()[:16])
        tracing.mark_phase("close-seal", seq, txs=len(ordered),
                           dur_ms=round(dur_s * 1e3, 3))
        _registry().meter("ledger.transaction.apply").mark(len(ordered))
        # per-close cost row: the post-mortem unit /closecosts
        # serves and anomaly bundles ship.  Deltas close over the whole
        # close (prefetch, apply loads and seal-phase snapshot churn all
        # land in the cache counters).
        _resident1 = self.bucket_list.decoded_entry_count()
        self.close_costs.add(
            seq=seq, txs=len(ordered), total_s=dur_s,
            fee_s=_fee_s, apply_s=_apply_s, seal_s=_seal_s,
            merge_stall_s=self.bucket_list.last_add_stall_s,
            cache_hits=_registry().meter(
                "bucketlistdb.cache.hit").count - _hits0,
            cache_misses=_registry().meter(
                "bucketlistdb.cache.miss").count - _miss0,
            pin_count=self.bucket_store.pin_count()
            if self.bucket_store is not None else 0,
            resident_entries=_resident1,
            resident_delta=_resident1 - _resident0,
            gc_backlog=seq - self._last_gc_seq
            if self.bucket_store is not None else 0)
        if self.meta_stream is not None:
            self._emit_close_meta(header_entry, meta_tx_set, result_pairs)
        return ClosedLedgerArtifacts(header_entry, tx_entry, result_entry)

    # -- Soroban phase -------------------------------------------
    def _apply_soroban_phase(self, ltx: LedgerTxn, soroban_ordered,
                             close_time: int, seq: int):
        """Apply the Soroban phase: partition into disjoint write-set
        clusters, apply clusters as parallel batches (serial when the
        partition is a single cluster or parallel apply is off), and
        return (frame, result) pairs in canonical order.  Serial and
        parallel runs are byte-identical — asserted end-to-end by
        tests/test_soroban.py and the loadgen campaign."""
        from ..soroban.scheduler import (apply_clusters_parallel,
                                         cluster_footprints)
        t0 = time.perf_counter()
        with detguard.region("soroban-apply"):
            clusters = cluster_footprints(soroban_ordered)
            _registry().histogram("soroban.apply.clusters").update(
                len(clusters))
            if not self.soroban_parallel_apply or len(clusters) <= 1:
                out = []
                for f in soroban_ordered:
                    with tracing.span("tx.apply"):
                        out.append((f, f.apply(ltx, close_time)))
            else:
                positions = {id(f): i for i, f in enumerate(soroban_ordered)}
                with tracing.span("soroban.parallel-apply",
                                  clusters=len(clusters)):
                    res_map = apply_clusters_parallel(
                        ltx, clusters,
                        lambda fr, cltx: fr.apply(cltx, close_time),
                        positions)
                out = [(f, res_map[id(f)]) for f in soroban_ordered]
        dur_s = time.perf_counter() - t0
        _registry().timer("soroban.apply.phase").update(dur_s)
        _registry().meter("soroban.transaction.apply").mark(
            len(soroban_ordered))
        eventlog.record("Ledger", "INFO", "soroban phase applied",
                        seq=seq, txs=len(soroban_ordered),
                        clusters=len(clusters),
                        parallel=bool(self.soroban_parallel_apply
                                      and len(clusters) > 1),
                        dur_ms=round(dur_s * 1e3, 3))
        tracing.mark_phase("soroban-apply", seq, txs=len(soroban_ordered),
                           clusters=len(clusters))
        return out

    _TTL_KEY_PREFIX = (9).to_bytes(4, "big")
    _CONTRACT_KEY_PREFIXES = ((6).to_bytes(4, "big"), (7).to_bytes(4, "big"))

    def _rebuild_ttl_index(self) -> dict:
        """Full scan rebuild of keyHash → [liveUntil, dataKeyXdr,
        durability] (loaded/assumed state arrives without one).  Only
        CONTRACT_DATA/CONTRACT_CODE/TTL keys are decoded — sniffed by
        the 4-byte LedgerEntryType prefix, so classic-only state pays
        one pass of byte compares and zero decodes."""
        idx: dict = {}
        for kb in self.root.all_keys():
            prefix = bytes(kb[:4])
            if prefix in self._CONTRACT_KEY_PREFIXES:
                key = X.LedgerKey.from_xdr(kb)
                dur = (key.value.durability
                       if key.switch == X.LedgerEntryType.CONTRACT_DATA
                       else X.ContractDataDurability.PERSISTENT)
                rec = idx.setdefault(sha256(kb), [0, None, None])
                rec[1], rec[2] = kb, dur
            elif prefix == self._TTL_KEY_PREFIX:
                entry = self.root.get_entry(kb)
                if entry is not None:
                    kh = bytes(entry.data.value.keyHash)
                    rec = idx.setdefault(kh, [0, None, None])
                    rec[0] = int(entry.data.value.liveUntilLedgerSeq)
        self._ttl_expiry = idx
        return idx

    def _note_soroban_delta(self, delta) -> None:
        """Fold one close's delta into the TTL expiry index (no-op for
        classic-only deltas; index is rebuilt lazily when None)."""
        idx = self._ttl_expiry
        if idx is None:
            return
        for kb, entry in delta.items():  # corelint: disable=iteration-order -- per-key hashing into a keyed index; order immaterial
            prefix = bytes(kb[:4])
            if prefix in self._CONTRACT_KEY_PREFIXES:
                kh = sha256(kb)
                if entry is None:
                    idx.pop(kh, None)
                else:
                    d = entry.data
                    dur = (d.value.durability
                           if d.switch == X.LedgerEntryType.CONTRACT_DATA
                           else X.ContractDataDurability.PERSISTENT)
                    rec = idx.setdefault(kh, [0, None, None])
                    rec[1], rec[2] = kb, dur
            elif prefix == self._TTL_KEY_PREFIX:
                if entry is not None:
                    kh = bytes(entry.data.value.keyHash)
                    rec = idx.setdefault(kh, [0, None, None])
                    rec[0] = int(entry.data.value.liveUntilLedgerSeq)

    def _evict_expired_ttl(self, ltx: LedgerTxn, seq: int) -> int:
        """State archival at the close edge: expired TEMPORARY entries
        (and their TTL entries) are erased; expired PERSISTENT entries
        stay put — they read as ENTRY_ARCHIVED until RestoreFootprint.
        Deterministic: expiry candidates walk in sorted keyHash order."""
        idx = self._ttl_expiry
        if idx is None:
            idx = self._rebuild_ttl_index()
        if not idx:
            return 0
        evicted = 0
        for kh in sorted(idx):
            live_until, data_kb, durability = idx[kh]
            if data_kb is None or live_until >= seq:
                continue
            if durability != X.ContractDataDurability.TEMPORARY:
                continue
            if ltx.get_entry(data_kb) is not None:
                ltx.erase(X.LedgerKey.from_xdr(data_kb))
                evicted += 1
            ttl_kb = X.LedgerKey.ttl(X.LedgerKeyTtl(keyHash=kh)).to_xdr()
            if ltx.get_entry(ttl_kb) is not None:
                ltx.erase(X.LedgerKey.from_xdr(ttl_kb))
        if evicted:
            _registry().meter("soroban.ttl.evicted").mark(evicted)
        return evicted

    def close_ledger_synthetic(self, init_entries: Sequence[X.LedgerEntry],
                               close_time: int) -> None:
        """Advance one ledger injecting `init_entries` directly — no txs,
        no fees, no signatures, no invariants (reference shape:
        BucketApplicator seeding state during ApplyBucketsWork, repurposed
        as the load-campaign seam for synthesizing account universes at
        millions-of-entries scale without replaying millions of
        CreateAccount ops).  Entries must be NEW keys (they land as INIT
        in the bucket list); the header advances and hashes exactly like
        a real close of an empty tx set over the mutated bucket list."""
        release_assert(self.root is not None,
                       "start_new_ledger/load first")
        # synthetic closes mutate the Python state directly: round-trip
        # the engine state so the two views cannot diverge.  Only when
        # the engine actually HOLDS authority — a degraded or
        # mid-catchup-deactivated closer must not overwrite newer Python
        # state with its stale export (nor be silently re-armed below)
        nc = self.native_closer
        nc_roundtrip = (nc is not None and nc.bridge.active
                        and nc.degraded is None)
        if nc_roundtrip:
            nc.bridge.export_to_manager(self)
        seq = self.lcl_header.ledgerSeq + 1
        entries = list(init_entries)
        for e in entries:
            e.lastModifiedLedgerSeq = seq
        # synthetic injections bypass _close_ledger: keep the TTL expiry
        # index honest for any contract/TTL entries seeded this way
        self._note_soroban_delta(
            {X.ledger_entry_key_xdr(e): e for e in entries})
        self.bucket_list.add_batch(seq, self.lcl_header.ledgerVersion,
                                   entries, [], [])
        if self.root.disk_backed:
            with tracing.span("bucket.snapshot"):
                self._refresh_snapshot(seq)
            self.bucket_list.enforce_residency()
            self._maybe_gc_buckets(seq)
        ltx = LedgerTxn(self.root)
        header = ltx.load_header()
        header.ledgerSeq = seq
        header.previousLedgerHash = self.lcl_hash
        header.scpValue = X.StellarValue(txSetHash=b"\x00" * 32,
                                         closeTime=close_time)
        header.txSetResultHash = sha256(
            X.TransactionResultSet(results=[]).to_xdr())
        header.bucketListHash = self.bucket_list.hash()
        self._update_skip_list(header)
        ltx.commit_header(header)
        if not self.root.disk_backed:
            for e in entries:
                ltx.create(e)
        ltx.commit()
        self.lcl_header = self.root.get_header()
        self.lcl_hash = sha256(self.lcl_header.to_xdr())
        if self.db is not None:
            self._persist_lcl()
        if nc_roundtrip:
            nc.bridge.import_from(self)

    def _emit_close_meta(self, header_entry, tx_set, result_pairs) -> None:
        """Emit LedgerCloseMeta v0 (reference: METADATA_OUTPUT_STREAM —
        one length-prefixed XDR frame per close)."""
        meta = X.LedgerCloseMeta.v0(X.LedgerCloseMetaV0(
            ledgerHeader=header_entry,
            txSet=tx_set,
            txProcessing=[X.TransactionResultMeta(
                result=p, feeProcessing=b"", txApplyProcessing=b"")
                for p in result_pairs],
            upgradesProcessing=[],
            scpInfo=[]))
        out = self.meta_stream
        if callable(out):
            out(meta)
        else:
            raw = meta.to_xdr()
            out.write(len(raw).to_bytes(4, "big") + raw)
            out.flush()

    # -- durable persistence -------------------------------------------------
    def enable_persistence(self, database, bucket_dir) -> None:
        """Attach a Database + BucketDir; every close (and the current LCL,
        immediately) is then durably recorded.  Reference: the implicit
        persistence of LedgerManagerImpl's SQL store + BucketManager."""
        self.db = database
        self.bucket_dir = bucket_dir
        if self.lcl_header is not None:
            self._persist_lcl()

    def _persist_lcl(self) -> None:
        """Bucket files first (content-addressed, idempotent), then the
        header row + storestate pointers in one sqlite transaction — a crash
        between the two leaves only orphaned bucket files, never a DB that
        references missing buckets.  Pending merges persist without
        blocking: resolved ones as their output, running ones as their
        inputs.

        The HAS is serialized ONCE and the level loop saves exactly the
        buckets that serialization recorded — serializing twice would race
        a background merge completing in between, and a HAS naming a
        state-1 output that was never written bricks restart."""
        from ..database import PersistentState
        from ..history.archive import HistoryArchiveState
        has = HistoryArchiveState.from_bucket_list(
            self.last_closed_ledger_seq, self.network_id.hex(),
            self.bucket_list, resolve=False)
        for lvl, lh in zip(self.bucket_list.levels, has.level_hashes):
            self.bucket_dir.save(lvl.curr)
            self.bucket_dir.save(lvl.snap)
            nxt = lh["next"]
            if nxt is None:
                continue
            if nxt["state"] == 1:
                # recorded as output ⇒ the merge was done at serialize
                # time; resolve() returns that same output instantly
                self.bucket_dir.save(lvl.next.resolve())
            else:
                curr_in, snap_in, _, _ = lvl.next.inputs
                self.bucket_dir.save(curr_in)
                self.bucket_dir.save(snap_in)
        self.db.store_header(self.lcl_hash, self.lcl_header)
        self.db.set_state(PersistentState.LAST_CLOSED_LEDGER,
                          self.lcl_hash.hex())
        self.db.set_state(PersistentState.HISTORY_ARCHIVE_STATE,
                          has.to_json())
        self.db.set_state(PersistentState.NETWORK_PASSPHRASE,
                          self.network_id.hex())
        self.db.commit()

    @classmethod
    def load_last_known_ledger(cls, network_id: bytes, database, bucket_dir,
                               invariant_manager=_DEFAULT_INVARIANTS,
                               bucket_store=None,
                               entry_cache_size: Optional[int] = None,
                               resident_levels: Optional[int] = None
                               ) -> "LedgerManager":
        """Rebuild a manager from durable state (reference:
        LedgerManagerImpl::loadLastKnownLedger): header from the DB, bucket
        list from on-disk bucket files named by the stored HAS, entry store
        re-derived newest-first from the bucket list, everything
        hash-verified against the stored header."""
        from ..database import PersistentState
        from ..history.archive import HistoryArchiveState
        from ..bucket.bucket_list import NUM_LEVELS

        # integrity audit BEFORE any on-disk state is trusted: every
        # manifest-listed bucket file must be present and every file must
        # hash to its name — a corrupted or vanished file (even one only a
        # pinned snapshot or publish queue still needs) fail-stops with a
        # diagnostic here instead of serving wrong ledger state later
        verified = bucket_dir.audit()
        log.info("bucket dir audit: %d files hash-verified", verified)

        lcl_hex = database.get_state(PersistentState.LAST_CLOSED_LEDGER)
        if lcl_hex is None:
            raise RuntimeError("database has no last closed ledger")
        stored_net = database.get_state(PersistentState.NETWORK_PASSPHRASE)
        if stored_net is not None and stored_net != network_id.hex():
            raise RuntimeError("database belongs to a different network")
        header = database.load_header_by_hash(bytes.fromhex(lcl_hex))
        if header is None:
            raise RuntimeError("stored LCL header missing")
        if sha256(header.to_xdr()) != bytes.fromhex(lcl_hex):
            raise RuntimeError("stored LCL header fails hash check")
        has_json = database.get_state(PersistentState.HISTORY_ARCHIVE_STATE)
        if has_json is None:
            raise RuntimeError("database has no archive state")
        has = HistoryArchiveState.from_json(has_json)

        mgr = cls(network_id, invariant_manager=invariant_manager,
                  bucket_store=bucket_store,
                  entry_cache_size=entry_cache_size,
                  resident_levels=resident_levels)
        hashes = has.bucket_hashes()
        if len(hashes) != NUM_LEVELS * 2:
            raise RuntimeError("stored HAS malformed")

        def source(idx: int):
            bucket = bucket_dir.load(hashes[idx])
            if bucket is None:
                raise RuntimeError(f"missing bucket {hashes[idx]}")
            return bucket

        def next_source(level: int):
            return has.rehydrate_next(level, bucket_dir.load)

        mgr.root = assume_bucket_state(mgr.bucket_list, header, source,
                                       next_source,
                                       store=bucket_store,
                                       entry_cache_size=mgr.entry_cache_size)
        mgr.lcl_header = header
        mgr.lcl_hash = bytes.fromhex(lcl_hex)
        mgr.db = database
        mgr.bucket_dir = bucket_dir
        mgr._ttl_expiry = None   # loaded state: rebuild index lazily
        log.info("resumed at ledger %d (%d entries)",
                 header.ledgerSeq, mgr.root.entry_count())
        return mgr

    def _update_skip_list(self, header: X.LedgerHeader) -> None:
        """Rotate the 4 skip hashes at their intervals (reference:
        LedgerHeaderUtils / updateSkipList in LedgerManagerImpl)."""
        sl = list(header.skipList)
        for i, interval in enumerate(SKIP_INTERVALS):
            if header.ledgerSeq % interval == 0:
                sl[i] = header.previousLedgerHash
        header.skipList = sl

    # -- accessors -----------------------------------------------------------
    @property
    def last_closed_ledger_seq(self) -> int:
        return self.lcl_header.ledgerSeq

    def make_frame(self, envelope: X.TransactionEnvelope) -> TransactionFrame:
        return TransactionFrame.make_from_wire(self.network_id, envelope)
