"""SearchableBucketListSnapshot: immutable point-in-time ledger-state reads.

Reference: src/bucket/SearchableBucketListSnapshot* + BucketSnapshotManager —
the reference hands read-only bucket-list snapshots to threads that must not
see (or block) the main thread's mutations: the HTTP query server
(`getledgerentry`), background tx-validation pre-flight, and parallel apply.
Since v21 the snapshot is also the AUTHORITATIVE read path: BucketListDB
serves every ledger-entry load from indexed bucket files.

Two view flavors compose a snapshot, one per non-empty bucket in
newest-first order (level 0 curr, level 0 snap, level 1 curr, ...):

* resident — the in-memory ``Bucket`` object (tests/sims, and any bucket
  the store has not persisted);
* disk — a ``DiskBucketIndex`` + the content-addressed file, so a lookup
  seeks to one record instead of holding decoded entries in memory.

When built against a ``BucketListStore`` the snapshot PINS its files for
its lifetime, so bucket GC after later closes never unlinks a file this
view still reads (release() drops the pins).  Buckets are immutable, so
later ``add_batch`` calls on the live list never mutate what this object
sees either way.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..util.lockorder import make_lock
from ..util.metrics import registry as _registry
from ..util.racetrace import race_checked
from ..xdr import LedgerEntry
from .bucket import _BE, Bucket, _is_dead

# probe() result: None = absent; (True, None) = tombstone; (False, entry)
_Probe = Optional[Tuple[bool, Optional[LedgerEntry]]]


class _ResidentView:
    """Read view over an in-memory bucket."""

    __slots__ = ("bucket",)

    def __init__(self, bucket: Bucket):
        self.bucket = bucket

    def maybe_contains(self, key_bytes: bytes) -> bool:
        return self.bucket.index().maybe_contains(key_bytes)

    def probe(self, key_bytes: bytes) -> _Probe:
        be = self.bucket.find(key_bytes)
        if be is None:
            return None
        return (True, None) if _is_dead(be) else (False, be.value)

    def probe_many(self, sorted_keys: List[bytes]) -> Dict[bytes, _Probe]:
        out: Dict[bytes, _Probe] = {}
        for kb in sorted_keys:
            hit = self.probe(kb)
            if hit is not None:
                out[kb] = hit
        return out

    def iter_keys(self) -> Iterator[Tuple[bytes, bool]]:
        for kb, be in zip(self.bucket.sort_keys(), self.bucket.entries):
            yield kb, _is_dead(be)

    def iter_entries(self) -> Iterator[Tuple[bytes, bool, Optional[LedgerEntry]]]:
        for kb, be in zip(self.bucket.sort_keys(), self.bucket.entries):
            dead = _is_dead(be)
            yield kb, dead, (None if dead else be.value)

    def iter_live_raw(self) -> Iterator[Tuple[bytes, bytes]]:
        packed = self.bucket.packed_entries()
        for kb, be, rec in zip(self.bucket.sort_keys(), self.bucket.entries,
                               packed):
            if not _is_dead(be):
                yield kb, rec[4:]   # strip the BucketEntry type tag


@race_checked
class _DiskView:
    """Read view over an on-disk bucket file via its DiskBucketIndex.
    One persistent file handle per view; reads are lock-serialized (the
    admin HTTP thread may share a snapshot with the main thread)."""

    __slots__ = ("index", "_f", "_lock", "_race_fields_")

    def __init__(self, index):
        self.index = index
        self._f = None
        self._lock = make_lock("bucket.snapshot-file")

    def _read(self, off: int, end: int) -> bytes:
        with self._lock:
            if self._f is None:
                self._f = open(self.index.path, "rb")
            self._f.seek(off)
            return self._f.read(end - off)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def maybe_contains(self, key_bytes: bytes) -> bool:
        return self.index.maybe_contains(key_bytes)

    def _decode(self, rec: bytes, off: int) -> LedgerEntry:
        try:
            be, _ = _BE.unpack_from_fast(rec, 0)
        except Exception as exc:
            raise RuntimeError(
                f"bucket file {self.index.path} has a corrupt record at "
                f"byte {off}: {exc}") from exc
        return be.value

    def probe(self, key_bytes: bytes) -> _Probe:
        hit = self.index.find(key_bytes)
        if hit is None:
            return None
        off, end, dead = hit
        if dead:
            return True, None          # tombstone: no file read needed
        return False, self._decode(self._read(off, end), off)

    def probe_many(self, sorted_keys: List[bytes]) -> Dict[bytes, _Probe]:
        """Batched point loads: resolve offsets first, then read in file
        order (one seek chain instead of key-order scatter)."""
        out: Dict[bytes, _Probe] = {}
        reads: List[Tuple[int, int, bytes]] = []
        for kb in sorted_keys:
            hit = self.index.find(kb)
            if hit is None:
                continue
            off, end, dead = hit
            if dead:
                out[kb] = (True, None)
            else:
                reads.append((off, end, kb))
        reads.sort()
        for off, end, kb in reads:
            out[kb] = (False, self._decode(self._read(off, end), off))
        return out

    def iter_keys(self) -> Iterator[Tuple[bytes, bool]]:
        idx = self.index
        for i, kb in enumerate(idx.keys()):
            yield kb, idx.is_dead(i)

    def iter_entries(self) -> Iterator[Tuple[bytes, bool, Optional[LedgerEntry]]]:
        for kb, dead, rec in self._iter_records():
            yield kb, dead, (None if dead else self._decode(rec, -1))

    def iter_live_raw(self) -> Iterator[Tuple[bytes, bytes]]:
        for kb, dead, rec in self._iter_records():
            if not dead:
                yield kb, rec[4:]

    def _iter_records(self) -> Iterator[Tuple[bytes, bool, bytes]]:
        idx = self.index
        keys = idx.keys()
        with open(idx.path, "rb") as f:
            for i, kb in enumerate(keys):
                off, end, dead = idx._record_bounds(i)
                f.seek(off)
                yield kb, dead, f.read(end - off)


@race_checked
class SearchableBucketListSnapshot:
    __slots__ = ("ledger_seq", "_views", "_store", "_pinned", "_load_timer",
                 "_probe_counters", "_live_count", "_pin_t0", "_pin_timer",
                 "_read_meter", "_race_fields_")

    def __init__(self, bucket_list, ledger_seq: int = 0, store=None):
        self.ledger_seq = ledger_seq
        self._store = store
        self._pinned: List[str] = []
        self._live_count: Optional[int] = None
        # newest-first: level 0 curr, level 0 snap, level 1 curr, ...
        self._views: List[Tuple[int, object]] = []
        for pos, bucket in enumerate(bucket_list.buckets()):
            if bucket.is_empty():
                continue
            level = pos // 2
            if store is not None:
                # a disk-resident bucket already carries its index
                # (streaming-merge output / residency pass) — unify the
                # seams: one _DiskView either way, no re-ensure scan
                idx = (bucket.disk_index() if bucket.is_disk_resident()
                       else store.ensure(bucket))
                self._views.append((level, _DiskView(idx)))
                self._pinned.append(bucket.hash().hex())
            elif bucket.is_disk_resident():
                # storeless view over a disk-resident bucket (tests,
                # tools): serve from the file rather than rehydrating
                self._views.append((level, _DiskView(bucket.disk_index())))
            else:
                self._views.append((level, _ResidentView(bucket)))
        if store is not None:
            store.pin(self._pinned)
        # metric handles resolved once per snapshot (a snapshot lives one
        # close; per-call registry lookups were measurable on the load path)
        reg = _registry()
        self._load_timer = reg.timer("bucketlistdb.load")
        self._probe_counters = {
            level: reg.counter(f"bucketlistdb.probe.level-{level}")
            for level in {lv for lv, _ in self._views}}
        # contention observability: how long readers hold GC
        # pins (recorded at release) and bulk-read key volume — the two
        # series the close-p99-vs-read-QPS curve correlates against
        self._pin_t0 = time.perf_counter()
        self._pin_timer = reg.timer("bucketlistdb.pin.held")
        self._read_meter = reg.meter("bucketlistdb.read.keys")

    # -- lifecycle -----------------------------------------------------------
    def release(self) -> None:
        """Drop file pins + handles; idempotent.  The LedgerManager calls
        this when a newer snapshot replaces this one — files this view
        referenced become GC-eligible again."""
        if self._store is not None and self._pinned:
            self._store.unpin(self._pinned)
            self._pinned = []
            # reader-held pin time: init (pin) to release (unpin); only
            # recorded for snapshots that actually held store pins
            self._pin_timer.update(time.perf_counter() - self._pin_t0)
        for _, view in self._views:
            if isinstance(view, _DiskView):
                view.close()

    def __del__(self):  # best-effort: a leaked snapshot must not leak pins
        try:
            self.release()
        except Exception:  # corelint: disable=exception-hygiene -- destructor cleanup must never raise
            pass

    # -- point reads ---------------------------------------------------------
    def load(self, key) -> Optional[LedgerEntry]:
        """Newest live version of a LedgerKey (or raw key bytes); None if
        absent or dead."""
        key_bytes = key if isinstance(key, bytes) else key.to_xdr()
        t0 = time.perf_counter()
        try:
            for level, view in self._views:
                if not view.maybe_contains(key_bytes):
                    continue
                self._probe_counters[level].inc()
                hit = view.probe(key_bytes)
                if hit is not None:
                    dead, entry = hit
                    return None if dead else entry
            return None
        finally:
            self._load_timer.update(time.perf_counter() - t0)

    def load_keys(self, keys: Iterable) -> Dict[bytes, LedgerEntry]:
        """Batched point loads (reference: loadKeysWithLimits); returns only
        the keys that exist, keyed by their XDR bytes.  Probes run
        level-major so disk views read each file in offset order — the bulk
        prefetch path for whole tx sets."""
        remaining = {key if isinstance(key, bytes) else key.to_xdr()
                     for key in keys}
        if remaining:
            self._read_meter.mark(len(remaining))
        out: Dict[bytes, LedgerEntry] = {}
        for level, view in self._views:
            if not remaining:
                break
            cand = sorted(kb for kb in remaining
                          if view.maybe_contains(kb))
            if not cand:
                continue
            self._probe_counters[level].inc(len(cand))
            hits = view.probe_many(cand)
            for kb, (dead, entry) in hits.items():
                remaining.discard(kb)
                if not dead:
                    out[kb] = entry
        return out

    # -- iteration -----------------------------------------------------------
    def iter_live_keys(self) -> Iterator[bytes]:
        """Every live LedgerKey (XDR bytes), newest record per key winning
        — no entry decode for disk views (index keys only)."""
        seen: set = set()
        for _, view in self._views:
            for kb, dead in view.iter_keys():
                if kb in seen:
                    continue
                seen.add(kb)
                if not dead:
                    yield kb

    def live_entry_count(self) -> int:
        """Number of live entries in this view (computed once per
        snapshot; key-only scan)."""
        if self._live_count is None:
            self._live_count = sum(1 for _ in self.iter_live_keys())
        return self._live_count

    def scan(self) -> Iterable[LedgerEntry]:
        """All live entries, newest version per key (reference: the
        in-order full-list scans used by dump-ledger / invariants)."""
        seen: set = set()
        for _, view in self._views:
            for kb, dead, entry in view.iter_entries():
                if kb in seen:
                    continue
                seen.add(kb)
                if not dead:
                    yield entry

    def iter_live_raw(self) -> Iterator[Tuple[bytes, bytes]]:
        """(key XDR, LedgerEntry XDR) for every live entry, newest record
        per key winning (tombstones shadow like everywhere else) — the
        native-engine import path, no Python entry decode."""
        seen: set = set()
        for _, view in self._views:
            for kb, rec in view.iter_live_raw():
                if kb not in seen:
                    yield kb, rec
            # ALL of this view's keys (incl. tombstones) shadow older views
            seen.update(kb for kb, _ in view.iter_keys())
