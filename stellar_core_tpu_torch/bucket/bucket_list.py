"""The 11-level log-structured BucketList (the ledger state's hash structure).

Reference: src/bucket/BucketListBase.{h,cpp} / LiveBucketList — levels of
(curr, snap) buckets, spill cadence in powers of 4, levelShouldSpill /
levelHalf / levelSize, getHash = tree of SHA-256s.

Merge scheduling follows the reference's commit/prepare pipeline exactly
(BucketLevel::commit / prepare / snap + FutureBucket): when level i−1 spills,
level i first *commits* the merge prepared at the previous spill (which had a
whole spill interval to run in the background) and then *prepares* a new
future merge of its curr with the incoming snap.  Between spills the pending
merge is invisible to the level hash — the spilled data remains visible as
level i−1's snap — so the hash evolution is deterministic regardless of
whether merges run synchronously (executor=None) or on a thread pool.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional

from ..crypto.sha import SHA256
from ..util.assertions import release_assert
from ..util.metrics import registry as _registry
from ..xdr import LedgerEntry, LedgerKey
from .bucket import Bucket, merge_buckets
from .future import FutureBucket

NUM_LEVELS = 11

# Residency depth default: levels < DEFAULT_RESIDENT_LEVELS keep decoded
# entries (they churn every few ledgers and feed the synchronous level-0
# merge); levels >= it are disk-resident once persisted+indexed, and their
# merges stream file-to-file (BUCKET_RESIDENT_LEVELS in config).
DEFAULT_RESIDENT_LEVELS = 2


def level_size(level: int) -> int:
    return 4 ** (level + 1)


def level_half(level: int) -> int:
    return level_size(level) // 2


def level_should_spill(ledger: int, level: int) -> bool:
    """Does `level` spill its curr on this ledger? (reference:
    BucketListBase::levelShouldSpill — at multiples of levelHalf)."""
    if level == NUM_LEVELS - 1:
        return False
    return ledger == (ledger // level_half(level)) * level_half(level)


def keep_tombstone_entries(level: int) -> bool:
    return level < NUM_LEVELS - 1


class BucketLevel:
    __slots__ = ("curr", "snap", "next")

    def __init__(self) -> None:
        self.curr = Bucket.empty()
        self.snap = Bucket.empty()
        self.next: Optional[FutureBucket] = None

    def snap_curr(self) -> Bucket:
        """curr → snap (reference: BucketLevel::snap; the pending future is
        untouched — it is committed by the level below's spill handling)."""
        self.snap = self.curr
        self.curr = Bucket.empty()
        return self.snap

    def commit(self) -> None:
        """Resolve the pending merge into curr (reference:
        BucketLevel::commit).  A streaming merge's output is now
        referenced by the level, so its adoption-time GC pin drops."""
        if self.next is not None:
            self.curr = self.next.resolve()
            self.next.release_output_pin()
            self.next = None

    def prepare(self, spill: Bucket, keep_tombstones: bool,
                protocol_version: int, executor=None,
                raw_store=None) -> None:
        """Start merging curr with the incoming spill (reference:
        BucketLevel::prepare → FutureBucket ctor on a worker thread).
        With `raw_store` the merge streams records file-to-file
        (merge_buckets_raw) and resolves to a disk-resident bucket."""
        release_assert(self.next is None,
                       "prepare() without a prior commit()")
        self.next = FutureBucket(self.curr, spill, keep_tombstones,
                                 protocol_version, executor,
                                 raw_store=raw_store)

    def hash(self) -> bytes:
        return SHA256().add(self.curr.hash()).add(self.snap.hash()).finish()


class BucketList:
    def __init__(self, executor=None) -> None:
        """executor: a concurrent.futures.Executor to run level merges in
        the background (reference: worker-thread FutureBucket merges), or
        None for synchronous merges — the outputs are identical either way."""
        self.levels: List[BucketLevel] = [BucketLevel() for _ in range(NUM_LEVELS)]
        self.executor = executor
        # residency (BucketListDB phase 2): unset = every bucket decoded
        self.store = None
        self.resident_levels = NUM_LEVELS
        self.peak_decoded_entries = 0
        # close-blocked-on-merge seconds for the most recent add_batch
        # (contention observability: read by the close path's
        # CloseCostRecord; 0.0 when every spill commit found its merge
        # already resolved)
        self.last_add_stall_s = 0.0  # corelint: disable=float-discipline -- contention telemetry, never ledger state

    # -- residency (BucketListDB phase 2) ------------------------------------
    def configure_residency(self, store, resident_levels: int) -> None:
        """Run levels >= `resident_levels` disk-resident against `store`
        (a BucketListStore): their merges stream file-to-file and their
        decoded entry lists drop after each close's enforce_residency().
        Level 0 must stay resident (its merge runs synchronously inside
        every close), so the floor is 1."""
        release_assert(store is not None, "residency needs a store")
        self.store = store
        self.resident_levels = max(1, min(int(resident_levels), NUM_LEVELS))
        _registry().gauge("bucket.resident.entries").set_source(
            self.decoded_entry_count)

    def decoded_entry_count(self) -> int:
        """Decoded BucketEntry objects currently held across the list
        (curr/snap plus already-materialized merge outputs; merge inputs
        alias curr/snap so they are not double-counted).  This is the
        memory story phase 2 bounds: O(working set + top levels) instead
        of O(ledger)."""
        total = 0
        for lvl in self.levels:
            total += lvl.curr.resident_entry_count()
            total += lvl.snap.resident_entry_count()
            if lvl.next is not None:
                out = lvl.next.peek()
                if out is not None:
                    total += out.resident_entry_count()
        return total

    def _note_decoded_peak(self) -> None:
        n = self.decoded_entry_count()
        if n > self.peak_decoded_entries:
            self.peak_decoded_entries = n

    def enforce_residency(self) -> None:
        """Drop decoded entries from levels >= resident_levels: persist +
        index each such bucket in the store (content addressing makes the
        repeat calls free) and flip it disk-resident.  Resolved pending
        merges convert too — a streaming merge's output already is, so in
        steady state this only catches buckets that entered decoded
        (restart, catchup assume, native export)."""
        if self.store is None:
            return
        self._note_decoded_peak()
        for i in range(self.resident_levels, NUM_LEVELS):
            lvl = self.levels[i]
            for b in (lvl.curr, lvl.snap):
                if not b.is_empty() and not b.is_disk_resident():
                    b.make_disk_resident(self.store.ensure(b))
            if lvl.next is not None:
                out = lvl.next.peek()
                if out is not None and not out.is_empty() \
                        and not out.is_disk_resident():
                    out.make_disk_resident(self.store.ensure(out))

    def add_batch(self, ledger_seq: int, protocol_version: int,
                  init_entries: Iterable[LedgerEntry],
                  live_entries: Iterable[LedgerEntry],
                  dead_keys: Iterable[LedgerKey]) -> None:
        """One ledger's changes enter level 0; spill boundaries snap the
        level above, commit the previously prepared merge and prepare the
        next one (reference: BucketListBase::addBatch)."""
        release_assert(ledger_seq > 0, "ledger_seq must be positive")
        stall_s = 0.0  # corelint: disable=float-discipline -- contention telemetry, never ledger state
        with _registry().timer("bucket.batch.addtime").time():
            for i in range(NUM_LEVELS - 1, 0, -1):
                if level_should_spill(ledger_seq, i - 1):
                    spill = self.levels[i - 1].snap_curr()
                    # contention seam: a spill commit whose
                    # background merge is still running blocks the close
                    # right here — time exactly that wait
                    nxt = self.levels[i].next
                    blocked = nxt is not None and not nxt.done
                    t0 = time.perf_counter() if blocked else 0.0  # corelint: disable=float-discipline -- contention telemetry, never ledger state
                    self.levels[i].commit()
                    if blocked:
                        stall_s += time.perf_counter() - t0
                    # deep levels merge decode-free, file-to-file
                    raw = self.store if (self.store is not None
                                         and i >= self.resident_levels) \
                        else None
                    self.levels[i].prepare(spill, keep_tombstone_entries(i),
                                           protocol_version, self.executor,
                                           raw_store=raw)
            fresh = Bucket.fresh(protocol_version, init_entries,
                                 live_entries, dead_keys)
            # level 0 merges synchronously every ledger (reference:
            # prepare + immediate commit — the batch is small and needed
            # for this ledger's hash)
            self.levels[0].prepare(fresh, True, protocol_version, None)
            self.levels[0].commit()
            if self.store is not None:
                self._note_decoded_peak()
        # recorded every batch (0.0 included): the merge-stall series
        # must baseline at "no stall" so the anomaly detector sees a
        # stall APPEARING, not only stalls getting worse
        self.last_add_stall_s = stall_s
        _registry().timer("bucket.merge.stall").update(stall_s)

    def hash(self) -> bytes:
        """bucketListHash in the ledger header: SHA-256 over level hashes
        (each SHA-256(curr.hash || snap.hash)); pending merges excluded."""
        h = SHA256()
        for lvl in self.levels:
            h.add(lvl.hash())
        return h.finish()

    def resolve_all_merges(self) -> None:
        """Block until every pending merge has an output (publish/persist
        barrier — the HAS serializes next as a resolved output hash)."""
        for lvl in self.levels:
            if lvl.next is not None:
                lvl.next.resolve()

    def referenced_hashes(self) -> List[str]:
        """Hex hashes of every bucket restart depends on — curr, snap and
        pending-merge outputs or inputs (reference:
        BucketManager::getAllReferencedBuckets feeding
        forgetUnreferencedBuckets).  Never blocks on a running merge."""
        out = []
        for lvl in self.levels:
            out.append(lvl.curr.hash().hex())
            out.append(lvl.snap.hash().hex())
            if lvl.next is not None:
                if lvl.next.done:
                    out.append(lvl.next.resolve().hash().hex())
                else:
                    curr_in, snap_in, _, _ = lvl.next.inputs
                    out.append(curr_in.hash().hex())
                    out.append(snap_in.hash().hex())
        return out

    def buckets(self) -> List[Bucket]:
        out = []
        for lvl in self.levels:
            out.append(lvl.curr)
            out.append(lvl.snap)
        return out

    def snapshot(self, ledger_seq: int = 0, store=None):
        """Immutable point-in-time view (reference:
        SearchableBucketListSnapshot via BucketSnapshotManager).  With a
        ``BucketListStore``, the view reads through on-disk bucket indexes
        and pins its files against GC (BucketListDB mode)."""
        from .snapshot import SearchableBucketListSnapshot
        return SearchableBucketListSnapshot(self, ledger_seq, store=store)

    def lookup_latest(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        """Newest version of a key across the list, or None if the newest
        record is a tombstone / the key is absent (reference:
        SearchableBucketListSnapshot::load — level 0 curr is newest)."""
        from .bucket import _is_dead
        for bucket in self.buckets():
            be = bucket.find(key_bytes)
            if be is not None:
                return None if _is_dead(be) else be.value
        return None
