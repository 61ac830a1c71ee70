"""The 11-level log-structured BucketList (the ledger state's hash structure).

Reference: src/bucket/BucketListBase.{h,cpp} / LiveBucketList — levels of
(curr, snap) buckets, spill cadence in powers of 4, levelShouldSpill /
levelHalf / levelSize, getHash = tree of SHA-256s.

Merge scheduling follows the reference's commit/prepare pipeline
(BucketLevel::commit / prepare / snap + FutureBucket): when level i−1
spills, level i first *commits* the merge prepared at the previous spill
and then *prepares* a new merge of its curr with the incoming snap.
Between spills the pending merge is invisible to the level hash — the
spilled data remains visible as level i−1's snap.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from ..crypto.sha import SHA256
from ..xdr import LedgerEntry, LedgerKey
from .bucket import Bucket
from .future import FutureBucket

NUM_LEVELS = 11


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
        """curr → snap (reference: BucketLevel::snap)."""
        self.snap = self.curr
        self.curr = Bucket.empty()
        return self.snap

    def commit(self) -> None:
        """The pending merge becomes curr (reference: BucketLevel::commit)."""
        if self.next is not None:
            self.curr = self.next.resolve()
            self.next = None

    def prepare(self, spill: Bucket, keep_tombstones: bool,
                protocol_version: int) -> None:
        """Merge curr with the incoming spill (reference:
        BucketLevel::prepare)."""
        assert self.next is None, "prepare() without a prior commit()"
        self.next = FutureBucket(self.curr, spill, keep_tombstones,
                                 protocol_version)

    def hash(self) -> bytes:
        return SHA256().add(self.curr.hash()).add(self.snap.hash()).finish()


class BucketList:
    def __init__(self) -> None:
        self.levels: List[BucketLevel] = [BucketLevel()
                                          for _ in range(NUM_LEVELS)]

    def add_batch(self, ledger_seq: int, protocol_version: int,
                  init_entries: Iterable[LedgerEntry],
                  live_entries: Iterable[LedgerEntry],
                  dead_keys: Iterable[LedgerKey]) -> None:
        """One ledger's changes enter level 0; spill boundaries snap the
        level above, commit the previously prepared merge and prepare the
        next one (reference: BucketListBase::addBatch)."""
        assert ledger_seq > 0, "ledger_seq must be positive"
        for i in range(NUM_LEVELS - 1, 0, -1):
            if level_should_spill(ledger_seq, i - 1):
                spill = self.levels[i - 1].snap_curr()
                self.levels[i].commit()
                self.levels[i].prepare(spill, keep_tombstone_entries(i),
                                       protocol_version)
        fresh = Bucket.fresh(protocol_version, init_entries,
                             live_entries, dead_keys)
        # level 0 merges every ledger (reference: prepare + immediate
        # commit)
        self.levels[0].prepare(fresh, True, protocol_version)
        self.levels[0].commit()

    def hash(self) -> bytes:
        """bucketListHash in the ledger header: SHA-256 over level hashes
        (each SHA-256(curr.hash || snap.hash)); pending merges excluded."""
        h = SHA256()
        for lvl in self.levels:
            h.add(lvl.hash())
        return h.finish()

    def buckets(self) -> List[Bucket]:
        out = []
        for lvl in self.levels:
            out.append(lvl.curr)
            out.append(lvl.snap)
        return out
