"""Content-addressed buckets and the exact-semantics merge.

Reference: src/bucket/Bucket.{h,cpp} (LiveBucket) and the CAP-20
INIT/LIVE/DEAD merge logic in src/bucket/BucketBase.cpp — merge (modern
protocol >= 12 semantics, no shadow buckets).

A bucket is an immutable, key-sorted sequence of BucketEntry XDR records,
headed by a METAENTRY carrying the protocol version; its identity is the
SHA-256 of the serialized stream (content addressing, same scheme the
reference uses for bucket files).  Buckets here are held in memory.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from ..crypto.sha import SHA256
from ..xdr import (BucketEntry, BucketEntryType, BucketMetadata, LedgerEntry,
                   LedgerKey, ledger_entry_key)

_BE = BucketEntry._xdr_adapter()


def pack_meta(protocol_version: int) -> bytes:
    """The METAENTRY record heading every serialized bucket stream."""
    return _BE.pack(BucketEntry.metaEntry(
        BucketMetadata(ledgerVersion=protocol_version)))


def entry_sort_key(be: BucketEntry) -> bytes:
    """Sort key: LedgerKey XDR bytes.  Type discriminant leads, then the
    per-type fields in declaration order — matches the reference's
    LedgerEntryIdCmp grouping (src/bucket/LedgerCmp.h) for classic types."""
    if be.switch == BucketEntryType.DEADENTRY:
        return be.value.to_xdr()
    if be.switch == BucketEntryType.METAENTRY:
        return b""  # meta sorts first
    return ledger_entry_key(be.value).to_xdr()


class Bucket:
    """Immutable sorted bucket. entries EXCLUDE the meta entry; protocol
    version is carried separately and re-serialized as METAENTRY."""

    __slots__ = ("entries", "protocol_version", "_hash", "_keys", "_packed")

    def __init__(self, entries: List[BucketEntry], protocol_version: int,
                 keys: List[bytes], packed: List[bytes]):
        self.entries = entries
        self.protocol_version = protocol_version
        self._hash: Optional[bytes] = None
        # sort keys and XDR records, aligned with entries: made once when
        # an entry first enters a bucket and carried through merges
        self._keys = keys
        self._packed = packed

    def __len__(self) -> int:
        return len(self.entries)

    def sort_keys(self) -> List[bytes]:
        return self._keys

    @staticmethod
    def empty() -> "Bucket":
        return Bucket([], 0, [], [])

    def is_empty(self) -> bool:
        return len(self) == 0

    def hash(self) -> bytes:
        """SHA-256 over the serialized stream (meta + entries); empty bucket
        hashes to 32 zero bytes (reference: Bucket::getHash of empty)."""
        if self._hash is None:
            if self.is_empty():
                self._hash = b"\x00" * 32
            else:
                self._hash = SHA256().add(self.serialize()).finish()
        return self._hash

    def serialize(self) -> bytes:
        if self.is_empty():
            return b""
        return pack_meta(self.protocol_version) + b"".join(self._packed)

    @staticmethod
    def fresh(protocol_version: int, init_entries: Iterable[LedgerEntry],
              live_entries: Iterable[LedgerEntry],
              dead_keys: Iterable[LedgerKey]) -> "Bucket":
        """One ledger's output as a bucket (reference: LiveBucket::fresh).
        Within a single batch a key appears at most once per class; the
        LedgerManager guarantees init/live/dead disjointness."""
        tagged: List[Tuple[bytes, BucketEntry]] = []
        for e in init_entries:
            be = BucketEntry.initEntry(e)
            tagged.append((entry_sort_key(be), be))
        for e in live_entries:
            be = BucketEntry.liveEntry(e)
            tagged.append((entry_sort_key(be), be))
        for k in dead_keys:
            be = BucketEntry.deadEntry(k)
            tagged.append((entry_sort_key(be), be))
        tagged.sort(key=lambda t: t[0])
        return Bucket([e for _, e in tagged], protocol_version,
                      [k for k, _ in tagged], [_BE.pack(e) for _, e in tagged])


def _is_init(be: BucketEntry) -> bool:
    return be.switch == BucketEntryType.INITENTRY


def _is_live(be: BucketEntry) -> bool:
    return be.switch == BucketEntryType.LIVEENTRY


def _is_dead(be: BucketEntry) -> bool:
    return be.switch == BucketEntryType.DEADENTRY


def merge_buckets(old: Bucket, new: Bucket, keep_tombstones: bool = True,
                  protocol_version: Optional[int] = None) -> Bucket:
    """Merge two key-sorted buckets, new entries shadowing old.

    CAP-20 pair rules (reference: BucketBase::merge + mergeCasesWithEqualKeys,
    protocol >= 12 semantics):
      (INIT, LIVE) -> INIT carrying the live value
      (INIT, DEAD) -> annihilate (both dropped)
      (DEAD, INIT) -> LIVE carrying the init value
      (LIVE, DEAD) -> DEAD tombstone
      otherwise    -> the newer entry
    keep_tombstones=False (bottom level): DEADs are dropped and INITs decay
    to LIVE (no deeper state left to annihilate against).
    """
    proto = protocol_version if protocol_version is not None else max(
        old.protocol_version, new.protocol_version)
    out: List[BucketEntry] = []
    out_keys: List[bytes] = []
    out_packed: List[bytes] = []

    def emit(be: BucketEntry, key: bytes, pb: Optional[bytes] = None):
        """pb: the entry's XDR record where it passes through unchanged
        from an input bucket."""
        if _is_dead(be) and not keep_tombstones:
            return
        if _is_init(be) and not keep_tombstones:
            be, pb = BucketEntry.liveEntry(be.value), None
        out.append(be)
        out_keys.append(key)
        out_packed.append(pb if pb is not None else _BE.pack(be))

    i = j = 0
    o, n = old.entries, new.entries
    o_keys, n_keys = old._keys, new._keys
    o_pk, n_pk = old._packed, new._packed
    while i < len(o) or j < len(n):
        if j >= len(n):
            emit(o[i], o_keys[i], o_pk[i]); i += 1
            continue
        if i >= len(o):
            emit(n[j], n_keys[j], n_pk[j]); j += 1
            continue
        ko, kn = o_keys[i], n_keys[j]
        if ko < kn:
            emit(o[i], ko, o_pk[i]); i += 1
        elif kn < ko:
            emit(n[j], kn, n_pk[j]); j += 1
        else:
            oe, ne, pb = o[i], n[j], n_pk[j]
            i += 1
            j += 1
            if _is_init(oe) and _is_live(ne):
                emit(BucketEntry.initEntry(ne.value), kn)
            elif _is_init(oe) and _is_dead(ne):
                pass  # annihilated
            elif _is_dead(oe) and _is_init(ne):
                emit(BucketEntry.liveEntry(ne.value), kn)
            else:
                emit(ne, kn, pb)
    return Bucket(out, proto, out_keys, out_packed)
