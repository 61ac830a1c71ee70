"""Content-addressed buckets and the exact-semantics merge.

Reference: src/bucket/Bucket.{h,cpp} (LiveBucket), BucketInputIterator /
BucketOutputIterator, and the CAP-20 INIT/LIVE/DEAD merge logic in
src/bucket/BucketBase.cpp — merge (modern protocol >= 12 semantics, no
shadow buckets).

A bucket is an immutable, key-sorted sequence of BucketEntry XDR records,
headed by a METAENTRY carrying the protocol version; its identity is the
SHA-256 of the serialized stream (content addressing, same scheme the
reference uses for bucket files).

Two residency modes (BucketListDB phase 2):

* decoded — the classic in-memory form: a ``List[BucketEntry]`` plus
  cached sort keys / packed records.
* disk-resident — the bucket is backed by its content-addressed file and
  ``DiskBucketIndex`` only; no decoded entries are held.  ``find`` seeks
  one record, iteration streams the file, and ``entries`` rehydrates
  lazily (counted by the ``bucket.rehydrate`` metrics) only when a
  consumer truly needs decoded objects.  ``merge_buckets_raw`` merges two
  buckets in either mode file-to-file without constructing BucketEntry
  objects (reference: BucketBase::merge streaming XDR records between
  BucketInputIterator and BucketOutputIterator).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..crypto.sha import SHA256
from ..xdr import (BucketEntry, BucketEntryType, BucketMetadata, LedgerEntry,
                   LedgerKey, ledger_entry_key)

_BE = BucketEntry._xdr_adapter()

# BucketEntry XDR discriminants as wire bytes (big-endian int32) — the raw
# merge decides CAP-20 pair rules from these without decoding records
LIVE_TAG = (BucketEntryType.LIVEENTRY).to_bytes(4, "big")
DEAD_TAG = (BucketEntryType.DEADENTRY).to_bytes(4, "big")
INIT_TAG = (BucketEntryType.INITENTRY).to_bytes(4, "big")


def pack_meta(protocol_version: int) -> bytes:
    """The METAENTRY record heading every serialized bucket stream."""
    return _BE.pack(BucketEntry.metaEntry(
        BucketMetadata(ledgerVersion=protocol_version)))


def _key_bytes(key: LedgerKey) -> bytes:
    """Sort key: LedgerKey XDR bytes.  Type discriminant leads, then the
    per-type fields in declaration order — matches the reference's
    LedgerEntryIdCmp grouping (src/bucket/LedgerCmp.h) for classic types."""
    return key.to_xdr()


def entry_sort_key(be: BucketEntry) -> bytes:
    if be.switch == BucketEntryType.DEADENTRY:
        return _key_bytes(be.value)
    if be.switch == BucketEntryType.METAENTRY:
        return b""  # meta sorts first
    return _key_bytes(ledger_entry_key(be.value))


class Bucket:
    """Immutable sorted bucket. entries EXCLUDE the meta entry; protocol
    version is carried separately and re-serialized as METAENTRY."""

    __slots__ = ("_entries", "protocol_version", "_hash", "_index", "_keys",
                 "_packed", "_disk")

    def __init__(self, entries: List[BucketEntry], protocol_version: int,
                 keys: Optional[List[bytes]] = None,
                 packed: Optional[List[Optional[bytes]]] = None):
        self._entries: Optional[List[BucketEntry]] = entries
        self.protocol_version = protocol_version
        self._hash: Optional[bytes] = None
        self._index = None
        self._keys = keys  # cached sort keys, aligned with entries
        # cached BucketEntry XDR bytes, aligned with entries (None holes
        # fill lazily).  Entries are shared objects across a merge chain,
        # so propagating the packed bytes through merges means each entry
        # is packed ONCE per lifetime instead of once per bucket hash
        # (bucket.hash() would otherwise re-pack every entry of every
        # bucket it hashes).  Memory: the ~150-300 B XDR
        # slice per entry is a fraction of the decoded entry's Python
        # object graph, and the bytes are SHARED across the merge chain
        # (not one copy per bucket).
        self._packed = packed
        # DiskBucketIndex backing a disk-resident bucket (entries dropped)
        self._disk = None

    # -- disk residency ------------------------------------------------------
    @staticmethod
    def from_disk(index, hash_bytes: bytes) -> "Bucket":
        """A bucket whose authoritative form is its on-disk file + index —
        no decoded entries are materialized (the streaming-merge output
        path and the deep-level residency path)."""
        b = Bucket.__new__(Bucket)
        b._entries = None
        b.protocol_version = index.protocol_version
        b._hash = hash_bytes
        b._index = None
        b._keys = index.keys()      # shared with the index, not a copy
        b._packed = None
        b._disk = index
        return b

    def disk_index(self):
        """The backing DiskBucketIndex, or None for a purely in-memory
        bucket."""
        return self._disk

    def is_disk_resident(self) -> bool:
        """True when no decoded entry list is held (reads go through the
        file + index)."""
        return self._disk is not None and self._entries is None

    def make_disk_resident(self, index) -> None:
        """Drop the decoded entry list; the bucket is served from `index`
        + its file from now on.  The content hash is pinned first (it is
        the bucket's identity and must not require a file re-read)."""
        if index is None:
            return  # the empty bucket has no file
        self.hash()
        self._disk = index
        self._entries = None
        self._packed = None
        self._keys = index.keys()
        self._index = None

    def resident_entry_count(self) -> int:
        """Decoded entries currently held (0 for disk-resident) — the
        bucket.resident.entries gauge sums this across the list."""
        return len(self._entries) if self._entries is not None else 0

    def _rehydrate(self) -> List[BucketEntry]:
        """Decode the backing file into entries (the escape hatch for
        consumers that truly need objects — dump tooling, invariants).
        Counted so regressions that silently re-decode deep levels show
        up in bucket.rehydrate.* metrics."""
        from ..util.metrics import registry as _registry
        with open(self._disk.path, "rb") as f:
            data = f.read()
        entries: List[BucketEntry] = []
        packed: List[Optional[bytes]] = []
        off = 0
        while off < len(data):
            start = off
            e, off = _BE.unpack_from_fast(data, off)
            if e.switch != BucketEntryType.METAENTRY:
                entries.append(e)
                packed.append(data[start:off])
        self._entries = entries
        self._packed = packed
        reg = _registry()
        reg.counter("bucket.rehydrate").inc()
        reg.counter("bucket.rehydrate.entries").inc(len(entries))
        return entries

    @property
    def entries(self) -> List[BucketEntry]:
        if self._entries is None:
            self._rehydrate()
        return self._entries

    def __len__(self) -> int:
        if self._entries is not None:
            return len(self._entries)
        return len(self._disk) if self._disk is not None else 0

    # -- caches --------------------------------------------------------------
    def sort_keys(self) -> List[bytes]:
        """Per-entry sort keys, computed once per immutable bucket (the
        merge path walks every level's keys each spill — recomputing the
        key XDR per merge was a top replay cost).  Disk-resident buckets
        share the index's key array."""
        if self._keys is None:
            if self._entries is None and self._disk is not None:
                self._keys = self._disk.keys()
            else:
                self._keys = [entry_sort_key(e) for e in self.entries]
        return self._keys

    def packed_entries(self) -> List[bytes]:
        """Per-entry serialized XDR, computed once per entry lifetime
        (propagated through merges; deserialize captures wire slices)."""
        if self._packed is None:
            if self._entries is None and self._disk is not None:
                # disk mode: slice the file without decoding and WITHOUT
                # caching — callers that need the records transiently
                # (native import) must not re-pin O(bucket) bytes
                return [rec for _, rec in self.iter_raw()]
            self._packed = [_BE.pack(e) for e in self.entries]
        else:
            pk = self._packed
            for i, p in enumerate(pk):
                if p is None:
                    pk[i] = _BE.pack(self._entries[i])
        return self._packed

    def raw_records(self) -> List[bytes]:
        """The packed BucketEntry records (no meta) — the native bridge's
        raw-record seam; disk-resident buckets slice their file without
        any decode."""
        return self.packed_entries()

    def iter_raw(self) -> Iterator[Tuple[bytes, bytes]]:
        """Stream (sort_key, packed_record) pairs without constructing
        BucketEntry objects — the merge_buckets_raw input contract.
        Decoded buckets zip their caches; disk-resident buckets read the
        file sequentially (one buffered pass, no decode)."""
        if self._entries is not None or self._disk is None:
            yield from zip(self.sort_keys(), self.packed_entries())
            return
        idx = self._disk
        keys = idx.keys()
        if not keys:
            return
        # records are contiguous (file = meta + concatenated records):
        # read strictly sequentially so the OS buffer does the batching,
        # not a seek per record
        with open(idx.path, "rb", buffering=1 << 16) as f:
            off0, _, _ = idx._record_bounds(0)
            f.seek(off0)
            for i, kb in enumerate(keys):
                off, end, _ = idx._record_bounds(i)
                yield kb, f.read(end - off)

    def index(self):
        """The bucket's point-lookup index, built lazily once per immutable
        bucket (reference: BucketManager::maybeBuildIndex)."""
        if self._index is None:
            from .index import BucketIndex
            self._index = BucketIndex(self.sort_keys())
        return self._index

    def find(self, key_bytes: bytes) -> Optional[BucketEntry]:
        """Indexed lookup by LedgerKey XDR bytes (entries are sorted by
        exactly this).  Disk-resident: one seek + one-record decode."""
        if self._entries is None and self._disk is not None:
            hit = self._disk.find(key_bytes)
            if hit is None:
                return None
            off, end, _ = hit
            with open(self._disk.path, "rb") as f:
                f.seek(off)
                rec = f.read(end - off)
            be, _ = _BE.unpack_from_fast(rec, 0)
            return be
        i = self.index().find(key_bytes)
        return self._entries[i] if i is not None else None

    @staticmethod
    def empty() -> "Bucket":
        return Bucket([], 0)

    def is_empty(self) -> bool:
        return len(self) == 0

    def hash(self) -> bytes:
        """SHA-256 over the serialized stream (meta + entries); empty bucket
        hashes to 32 zero bytes (reference: Bucket::getHash of empty)."""
        if self._hash is None:
            if self.is_empty():
                self._hash = b"\x00" * 32
            else:
                h = SHA256()
                h.add(pack_meta(self.protocol_version))
                for p in self.packed_entries():
                    h.add(p)
                self._hash = h.finish()
        return self._hash

    def serialize(self) -> bytes:
        if self.is_empty():
            return b""
        if self._entries is None and self._disk is not None:
            with open(self._disk.path, "rb") as f:
                return f.read()
        return pack_meta(self.protocol_version) + b"".join(
            self.packed_entries())

    @staticmethod
    def deserialize(data: bytes) -> "Bucket":
        entries: List[BucketEntry] = []
        packed: List[Optional[bytes]] = []
        off = 0
        protocol = 0
        while off < len(data):
            start = off
            e, off = _BE.unpack_from_fast(data, off)
            if e.switch == BucketEntryType.METAENTRY:
                protocol = e.value.ledgerVersion
            else:
                entries.append(e)
                packed.append(data[start:off])   # wire slice: free cache
        return Bucket(entries, protocol, packed=packed)

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
                      keys=[k for k, _ in tagged])

    def __iter__(self):
        return iter(self.entries)


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
    out_packed: List[Optional[bytes]] = []

    def emit(be: BucketEntry, key: bytes, pb: Optional[bytes] = None):
        """pb: the entry's cached XDR bytes when it passes through
        UNCHANGED from an input bucket (None for merge-constructed
        entries — packed lazily if/when the output is hashed)."""
        if _is_dead(be):
            if keep_tombstones:
                out.append(be)
                out_keys.append(key)
                out_packed.append(pb)
        elif _is_init(be) and not keep_tombstones:
            out.append(BucketEntry.liveEntry(be.value))
            out_keys.append(key)
            out_packed.append(None)   # re-tagged: bytes differ
        else:
            out.append(be)
            out_keys.append(key)
            out_packed.append(pb)

    i = j = 0
    o, n = old.entries, new.entries
    o_keys = old.sort_keys()
    n_keys = new.sort_keys()
    o_pk = old._packed
    n_pk = new._packed

    def opb(i):
        return o_pk[i] if o_pk is not None else None

    def npb(j):
        return n_pk[j] if n_pk is not None else None

    while i < len(o) or j < len(n):
        if j >= len(n):
            emit(o[i], o_keys[i], opb(i)); i += 1
            continue
        if i >= len(o):
            emit(n[j], n_keys[j], npb(j)); j += 1
            continue
        ko, kn = o_keys[i], n_keys[j]
        if ko < kn:
            emit(o[i], ko, opb(i)); i += 1
        elif kn < ko:
            emit(n[j], kn, npb(j)); j += 1
        else:
            oe, ne = o[i], n[j]
            pb = npb(j)
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
    return Bucket(out, proto, keys=out_keys, packed=out_packed)


def merge_buckets_raw(old: Bucket, new: Bucket, keep_tombstones: bool,
                      protocol_version: Optional[int], store) -> Bucket:
    """The streaming flavor of merge_buckets: identical CAP-20 semantics
    decided from the 4-byte XDR discriminant of each packed record — no
    BucketEntry is constructed for any record, pass-through or merged
    (reference: BucketBase::merge pumping BucketInputIterators into a
    BucketOutputIterator file-to-file).  Output records and an incremental
    DiskBucketIndex stream straight into `store` (a BucketListStore); the
    result is a disk-resident Bucket whose hash is bit-identical to the
    in-memory merge's.  Memory: the two input cursors plus the output
    index — no decoded entries, O(1) records in flight.

    Pair-rule/tag mapping (body = record minus its 4-byte tag; the merged
    value's wire bytes ARE the newer record's body, so re-tagging is a
    4-byte splice):
      (INIT, LIVE) -> INIT_TAG + live body
      (INIT, DEAD) -> nothing
      (DEAD, INIT) -> LIVE_TAG + init body
      otherwise    -> the newer record verbatim
    keep_tombstones=False: DEAD dropped, INIT re-tagged LIVE.
    """
    proto = protocol_version if protocol_version is not None else max(
        old.protocol_version, new.protocol_version)
    if old.is_empty() and new.is_empty():
        return Bucket([], proto)
    writer = store.stream_writer(proto)
    try:
        w = writer.write

        def emit(key: bytes, rec: bytes) -> None:
            tag = rec[:4]
            if tag == DEAD_TAG:
                if keep_tombstones:
                    w(key, rec)
            elif tag == INIT_TAG and not keep_tombstones:
                w(key, LIVE_TAG + rec[4:])
            else:
                w(key, rec)

        _SENT = (None, None)
        oit = old.iter_raw()
        nit = new.iter_raw()
        ok, orec = next(oit, _SENT)
        nk, nrec = next(nit, _SENT)
        while ok is not None or nk is not None:
            if nk is None or (ok is not None and ok < nk):
                emit(ok, orec)
                ok, orec = next(oit, _SENT)
            elif ok is None or nk < ok:
                emit(nk, nrec)
                nk, nrec = next(nit, _SENT)
            else:
                ot, nt = orec[:4], nrec[:4]
                if ot == INIT_TAG and nt == LIVE_TAG:
                    emit(nk, INIT_TAG + nrec[4:])
                elif ot == INIT_TAG and nt == DEAD_TAG:
                    pass  # annihilated
                elif ot == DEAD_TAG and nt == INIT_TAG:
                    emit(nk, LIVE_TAG + nrec[4:])
                else:
                    emit(nk, nrec)
                ok, orec = next(oit, _SENT)
                nk, nrec = next(nit, _SENT)
        return writer.finalize()
    except BaseException:
        writer.abort()
        raise
