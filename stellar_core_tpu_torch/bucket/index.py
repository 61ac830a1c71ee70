"""BucketIndex: per-bucket point-lookup acceleration.

Reference: src/bucket/BucketIndexImpl.{h,cpp} — the reference keeps, per
bucket file, (a) a sorted key→offset index (individual or page-ranged) and
(b) a binary-fuse membership filter so that the common case — "this bucket
does not contain the key" — is answered without touching the file at all.

Two index flavors live here:

* ``BucketIndex`` — over an in-memory bucket's sorted entry list: the
  sorted LedgerKey-bytes array for bisection plus a set of 64-bit key
  fingerprints (CPython's SipHash via ``hash()``) as the membership filter.
* ``DiskBucketIndex`` — over an on-disk bucket FILE (the BucketListDB
  authority, reference: BucketIndexImpl over bucket-<hash>.xdr): the same
  sorted keys + filter, but each key maps to the byte range of its
  serialized BucketEntry record so a lookup SEEKS into the file instead of
  requiring the decoded entries resident in memory.

A ``lookup_latest`` over the 11-level list probes up to 22 buckets, of
which at most a handful contain the key — the filter turns the other ~20
probes into one set lookup each instead of an O(log n) bisection.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import List, Optional, Tuple

from ..crypto.sha import SHA256


class BucketIndex:
    """Immutable index over one bucket's (sorted) entries."""

    __slots__ = ("_keys", "_filter")

    def __init__(self, sort_keys: List[bytes]):
        self._keys = sort_keys
        self._filter = frozenset(map(hash, sort_keys))

    def __len__(self) -> int:
        return len(self._keys)

    def maybe_contains(self, key_bytes: bytes) -> bool:
        """False ⇒ definitely absent (the fast negative path); True ⇒ must
        bisect (no false negatives, same contract as the fuse filter)."""
        return hash(key_bytes) in self._filter  # corelint: disable=hash-order -- process-local membership filter; fingerprints never serialized

    def find(self, key_bytes: bytes) -> Optional[int]:
        """Position of the entry with this exact LedgerKey, or None."""
        if hash(key_bytes) not in self._filter:  # corelint: disable=hash-order -- process-local membership filter; fingerprints never serialized
            return None
        i = bisect_left(self._keys, key_bytes)
        if i < len(self._keys) and self._keys[i] == key_bytes:
            return i
        return None

    def lower_bound(self, key_bytes: bytes) -> int:
        """First position with sort key >= key_bytes (range scans: the
        reference's page-index getOffsetBounds analog)."""
        return bisect_left(self._keys, key_bytes)


class DiskBucketIndex:
    """Sorted key→(offset, end) table over one on-disk bucket file, plus
    the fingerprint membership filter and a per-entry tombstone flag.

    Built either from the in-memory bucket at save time (``from_bucket`` —
    no file re-read, offsets derived from the packed records the save just
    wrote) or by a hash-verified scan of an existing file (``build`` — the
    restart/catchup path; a corrupt file FAIL-STOPS here, it never serves
    lookups).  Record i spans [offsets[i], offsets[i+1]) with the final
    bound at end-of-file; record bytes start with the 4-byte BucketEntry
    type tag, so deadness is known without decoding.
    """

    __slots__ = ("path", "protocol_version", "_keys", "_offsets",
                 "_file_size", "_dead", "_filter")

    def __init__(self, path: str, protocol_version: int, keys: List[bytes],
                 offsets: List[int], file_size: int, dead: bytes):
        self.path = path
        self.protocol_version = protocol_version
        self._keys = keys
        self._offsets = offsets
        self._file_size = file_size
        self._dead = dead                      # aligned 0/1 per entry
        self._filter = frozenset(map(hash, keys))

    # -- construction --------------------------------------------------------
    @classmethod
    def from_bucket(cls, bucket, path: str) -> "DiskBucketIndex":
        """Index the file just written for `bucket` using its cached sort
        keys and packed records (the hot path: one ledger close saves level
        0 curr every ledger — no re-read, no re-decode)."""
        from .bucket import _BE, BucketEntry, BucketEntryType, BucketMetadata
        meta_len = len(_BE.pack(BucketEntry.metaEntry(
            BucketMetadata(ledgerVersion=bucket.protocol_version))))
        keys = bucket.sort_keys()
        offsets: List[int] = []
        off = meta_len
        for rec in bucket.packed_entries():
            offsets.append(off)
            off += len(rec)
        dead = bytes(1 if e.switch == BucketEntryType.DEADENTRY else 0
                     for e in bucket.entries)
        return cls(path, bucket.protocol_version, keys, offsets, off, dead)

    @classmethod
    def build(cls, path: str, expected_hex_hash: Optional[str] = None
              ) -> "DiskBucketIndex":
        """Scan + index an existing bucket file, verifying its content hash
        (when given) and key ordering.  Corruption raises RuntimeError —
        silently indexing a damaged file would serve wrong ledger state."""
        from .bucket import _BE, BucketEntryType, entry_sort_key
        with open(path, "rb") as f:
            data = f.read()
        if expected_hex_hash is not None:
            got = SHA256().add(data).finish().hex() if data else "0" * 64
            if got != expected_hex_hash:
                raise RuntimeError(
                    f"bucket file {path} fails hash check while indexing "
                    f"(got {got[:16]}..., want {expected_hex_hash[:16]}...)")
        keys: List[bytes] = []
        offsets: List[int] = []
        dead = bytearray()
        protocol = 0
        off = 0
        prev_key: Optional[bytes] = None
        while off < len(data):
            start = off
            try:
                e, off = _BE.unpack_from_fast(data, off)
            except Exception as exc:
                raise RuntimeError(
                    f"bucket file {path} has a corrupt record at byte "
                    f"{start}: {exc}") from exc
            if e.switch == BucketEntryType.METAENTRY:
                protocol = e.value.ledgerVersion
                continue
            kb = entry_sort_key(e)
            if prev_key is not None and kb <= prev_key:
                raise RuntimeError(
                    f"bucket file {path} keys out of order at byte {start}")
            prev_key = kb
            keys.append(kb)
            offsets.append(start)
            dead.append(1 if e.switch == BucketEntryType.DEADENTRY else 0)
        return cls(path, protocol, keys, offsets, len(data), bytes(dead))

    # -- lookups -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._keys)

    def maybe_contains(self, key_bytes: bytes) -> bool:
        return hash(key_bytes) in self._filter  # corelint: disable=hash-order -- process-local membership filter; fingerprints never serialized

    def find(self, key_bytes: bytes) -> Optional[Tuple[int, int, bool]]:
        """(offset, end, is_dead) of the record with this exact LedgerKey,
        or None — the reference's getOffsetBounds point-lookup."""
        if hash(key_bytes) not in self._filter:  # corelint: disable=hash-order -- process-local membership filter; fingerprints never serialized
            return None
        i = bisect_left(self._keys, key_bytes)
        if i < len(self._keys) and self._keys[i] == key_bytes:
            return self._record_bounds(i)
        return None

    def _record_bounds(self, i: int) -> Tuple[int, int, bool]:
        end = self._offsets[i + 1] if i + 1 < len(self._offsets) \
            else self._file_size
        return self._offsets[i], end, bool(self._dead[i])

    def keys(self) -> List[bytes]:
        """The sorted key array (aligned with is_dead) — snapshot key
        iteration reads this without touching the file."""
        return self._keys

    def is_dead(self, i: int) -> bool:
        return bool(self._dead[i])
