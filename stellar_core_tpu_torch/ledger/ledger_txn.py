"""LedgerTxn: nested transactional read/write cache over ledger entries.

Reference: src/ledger/LedgerTxn.{h,cpp} — AbstractLedgerTxn, LedgerTxn,
LedgerTxnRoot(Impl), LedgerTxnHeader.  Semantics kept: nested txns see
parent state through a copy-on-write delta; commit folds the delta into the
parent, rollback discards it; at most one active child; header mutations are
transactional alongside entries.

Root storage (SURVEY §2.1 row 9): since v21 the reference's bucket list IS
the ledger-entry database (BucketListDB — LedgerTxnRoot reads through
SearchableBucketListSnapshot over indexed bucket files, with a bounded
entry cache).  This root mirrors the read architecture: in BucketListDB
mode (constructed with a snapshot) every read goes through the snapshot's
on-disk indexes and a bounded LRU entry cache, so the ROOT holds at most
`entry_cache_size` decoded entries instead of one per live key.  (Phase 2:
BucketList levels >= BUCKET_RESIDENT_LEVELS are disk-resident too — their
buckets hold no decoded entries and merge via the streaming decode-free
path, see bucket/bucket.py merge_buckets_raw.)  The legacy in-memory dict
remains behind the `in_memory_ledger` config flag (the default for
tests/sims — reference analog: the deprecated in-memory SQL ledger
state).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..util.cache import LRUCache
from ..util.metrics import registry as _registry
from ..xdr import (LedgerEntry, LedgerHeader, LedgerKey, deep_copy_value,
                   ledger_entry_key, ledger_entry_key_xdr)


class LedgerTxnError(Exception):
    pass


class AbstractLedgerTxnParent:
    def get_entry(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        raise NotImplementedError

    def get_header(self) -> LedgerHeader:
        raise NotImplementedError

    def _attach_child(self, child: "LedgerTxn") -> None:
        raise NotImplementedError

    def _detach_child(self) -> None:
        raise NotImplementedError

    def all_keys(self) -> Iterator[bytes]:
        raise NotImplementedError


class LedgerTxnRoot(AbstractLedgerTxnParent):
    """Authoritative live-entry store + last closed header.

    Default (in-memory) mode keeps every live entry in a dict.  In
    BucketListDB mode (``snapshot`` given) the dict is RETIRED: reads go
    through the snapshot's indexed on-disk bucket files, with a bounded
    LRU entry cache in front (negative results — "definitively absent" —
    are cached too, sparing repeated 22-bucket probe chains).  The
    LedgerManager swaps in a fresh snapshot after every bucket-list
    mutation (ledger close seal, catchup assume-state, native-engine
    export); committed deltas land in the cache, so between the snapshot
    refresh and the next one the cache carries exactly the keys the
    snapshot does not yet serve.
    """

    _MISS = object()   # cache sentinel: distinguishes a cached None

    def __init__(self, header: LedgerHeader, snapshot=None,
                 entry_cache_size: int = 4096):
        self._header = header
        self._child: Optional[LedgerTxn] = None
        self._snapshot = snapshot
        if snapshot is None:
            self._entries: Optional[Dict[bytes, LedgerEntry]] = {}
            self._cache: Optional[LRUCache] = None
        else:
            self._entries = None
            self._cache = LRUCache(entry_cache_size)
            self._bind_metrics()

    def _bind_metrics(self) -> None:
        # re-resolved on every snapshot swap: the registry can be replaced
        # wholesale (tests' reset_registry) and cached handles would feed
        # a dead object for the rest of the manager's life
        reg = _registry()
        self._cache_hit = reg.meter("bucketlistdb.cache.hit")
        self._cache_miss = reg.meter("bucketlistdb.cache.miss")
        self._prefetch_timer = reg.timer("bucketlistdb.prefetch")

    @property
    def disk_backed(self) -> bool:
        return self._snapshot is not None

    # -- parent protocol ----------------------------------------------------
    def get_entry(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        if self._snapshot is None:
            return self._entries.get(key_bytes)
        v = self._cache.get(key_bytes, self._MISS)
        if v is not self._MISS:
            self._cache_hit.mark()
            return v
        self._cache_miss.mark()
        v = self._snapshot.load(key_bytes)
        self._cache.put(key_bytes, v)
        return v

    def get_header(self) -> LedgerHeader:
        return self._header

    def _attach_child(self, child: "LedgerTxn") -> None:
        if self._child is not None:
            raise LedgerTxnError("LedgerTxnRoot already has an active child")
        self._child = child

    def _detach_child(self) -> None:
        self._child = None

    def all_keys(self) -> Iterator[bytes]:
        if self._snapshot is None:
            return iter(list(self._entries.keys()))  # corelint: disable=iteration-order -- _entries is insertion-ordered (apply order); consumers do keyed scans
        return self._snapshot.iter_live_keys()

    # -- root-only ----------------------------------------------------------
    def _apply_delta(self, entries: Dict[bytes, Optional[LedgerEntry]],
                     header: Optional[LedgerHeader]) -> None:
        if self._snapshot is None:
            for k, e in entries.items():
                if e is None:
                    self._entries.pop(k, None)
                else:
                    self._entries[k] = e
        else:
            # deletions cache as None (negative entries); the bucket list
            # is the authority and the manager has already fed it this
            # delta by the time the commit lands here
            for k, e in entries.items():
                self._cache.put(k, e)
        if header is not None:
            self._header = header

    def set_header(self, header: LedgerHeader) -> None:
        self._header = header

    def set_snapshot(self, snapshot):
        """Swap in a fresh read view after a bucket-list mutation; returns
        the previous snapshot (caller releases its pins).  The entry cache
        survives: committed deltas were applied to it, everything else is
        unchanged between consecutive views."""
        old = self._snapshot
        self._snapshot = snapshot
        self._bind_metrics()
        return old

    def release_snapshot(self) -> None:
        """Drop this root's read view + its file pins (the root is being
        replaced wholesale — genesis scaffolding, native-engine export)."""
        if self._snapshot is not None:
            self._snapshot.release()
            self._snapshot = None

    def prefetch(self, keys: Iterable[bytes]) -> int:
        """Bulk-load `keys` into the entry cache via one batched snapshot
        pass (reference: LedgerTxnRoot::prefetchClassic before tx-set
        apply).  Absent keys cache as definitive misses.  Returns the
        number of keys actually probed."""
        if self._snapshot is None:
            return 0
        cache = self._cache
        missing = [kb for kb in keys if kb not in cache]
        if not missing:
            return 0
        import time as _time
        t0 = _time.perf_counter()
        found = self._snapshot.load_keys(missing)
        for kb in missing:
            cache.put(kb, found.get(kb))
        self._prefetch_timer.update(_time.perf_counter() - t0)
        return len(missing)

    def cache_stats(self) -> Dict[str, float]:
        """Entry-cache occupancy + hit rate (bench exposure)."""
        if self._cache is None:
            return {}
        return {"size": len(self._cache), "max_size": self._cache.max_size,
                "hits": self._cache.hits, "misses": self._cache.misses,
                "hit_rate": round(self._cache.hit_rate(), 4)}

    def entry_count(self) -> int:
        if self._snapshot is None:
            return len(self._entries)
        return self._snapshot.live_entry_count()

    def export_raw_entries(self) -> List[Tuple[bytes, bytes]]:
        """(LedgerKey XDR, LedgerEntry XDR) for every live entry — the
        native-engine import seam.  Only valid on a SETTLED root (no close
        in flight): in disk mode the snapshot must already reflect every
        committed delta.  Disk mode streams raw records (no entry
        decode)."""
        if self._snapshot is None:
            # canonical key order — the disk-mode twin streams bucket
            # records, which are already key-sorted
            return [(kb, e.to_xdr())
                    for kb, e in sorted(self._entries.items())]
        return list(self._snapshot.iter_live_raw())


class LedgerTxn(AbstractLedgerTxnParent):
    """One nesting level.  Use as a context manager or call commit/rollback
    explicitly; falling out of scope without commit == rollback (matches the
    reference's destructor behavior)."""

    # Instances are thread-confined: the soroban cluster workers each build
    # a PRIVATE LedgerTxn chain, and their only reach into the shared close
    # ltx goes through _ClusterBase, which serializes on the
    # soroban.cluster-read lock (see soroban/scheduler.py).
    def __init__(self, parent: AbstractLedgerTxnParent):
        self._parent = parent
        self._delta: Dict[bytes, Optional[LedgerEntry]] = {}  # corelint: owned-by=instance-thread -- per-instance; cross-thread reads serialize at _ClusterBase
        self._header: Optional[LedgerHeader] = None  # corelint: owned-by=instance-thread -- per-instance; cross-thread reads serialize at _ClusterBase
        self._child: Optional[LedgerTxn] = None  # corelint: owned-by=instance-thread -- per-instance; cluster chains never span threads
        self._open = True  # corelint: owned-by=instance-thread -- per-instance; cluster chains never span threads
        parent._attach_child(self)

    # -- context manager ----------------------------------------------------
    def __enter__(self) -> "LedgerTxn":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._open:
            self.rollback()

    # -- parent protocol (for nested children; no seal check — the child
    #    delegates reads through its sealed ancestors by design) ------------
    def get_entry(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        if not self._open:
            raise LedgerTxnError("LedgerTxn is closed")
        if key_bytes in self._delta:
            return self._delta[key_bytes]
        return self._parent.get_entry(key_bytes)

    def get_header(self) -> LedgerHeader:
        if self._header is not None:
            return self._header
        return self._parent.get_header()

    def _attach_child(self, child: "LedgerTxn") -> None:
        if self._child is not None:
            raise LedgerTxnError("LedgerTxn already has an active child")
        self._child = child

    def _detach_child(self) -> None:
        self._child = None

    def all_keys(self) -> Iterator[bytes]:
        seen = set()
        for k in self._parent.all_keys():
            seen.add(k)
        for k, v in self._delta.items():
            if v is None:
                seen.discard(k)
            else:
                seen.add(k)
        return iter(seen)

    # -- entry operations ----------------------------------------------------
    def load(self, key: LedgerKey) -> Optional[LedgerEntry]:
        """Copy-out load (deep — struct .copy() is shallow); mutate the
        copy then put() it back."""
        return self.load_by_bytes(key.to_xdr())

    def load_by_bytes(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        """load() for callers that already hold the key's XDR bytes (the
        account hot path memoizes them — xdr.account_key_xdr)."""
        self._assert_open_no_child()
        e = self.get_entry(key_bytes)
        # deep_copy_value dispatches straight to the native copier,
        # skipping the per-entry Python method wrapper (hot path)
        return deep_copy_value(e) if e is not None else None

    def exists(self, key: LedgerKey) -> bool:
        self._assert_open_no_child()
        return self.get_entry(key.to_xdr()) is not None

    def create(self, entry: LedgerEntry) -> None:
        self._assert_open_no_child()
        kb = ledger_entry_key_xdr(entry)
        if self.get_entry(kb) is not None:
            raise LedgerTxnError("create: entry already exists")
        self._delta[kb] = entry

    def put(self, entry: LedgerEntry) -> None:
        """Create-or-update (reference: LedgerTxn::createWithoutLoading /
        updateWithoutLoading pair)."""
        self._assert_open_no_child()
        self._delta[ledger_entry_key_xdr(entry)] = entry

    def update(self, entry: LedgerEntry) -> None:
        self._assert_open_no_child()
        kb = ledger_entry_key_xdr(entry)
        if self.get_entry(kb) is None:
            raise LedgerTxnError("update: entry does not exist")
        self._delta[kb] = entry

    def erase(self, key: LedgerKey) -> None:
        self._assert_open_no_child()
        kb = key.to_xdr()
        if self.get_entry(kb) is None:
            raise LedgerTxnError("erase: entry does not exist")
        self._delta[kb] = None

    # -- header operations ---------------------------------------------------
    def load_header(self) -> LedgerHeader:
        """Copy-out header; mutate and commit_header() it."""
        self._assert_open_no_child()
        return self.get_header().copy()

    def commit_header(self, header: LedgerHeader) -> None:
        self._assert_open_no_child()
        self._header = header

    # -- lifecycle -----------------------------------------------------------
    def commit(self) -> None:
        self._assert_open_no_child()
        parent = self._parent
        if isinstance(parent, LedgerTxn):
            parent._delta.update(self._delta)
            if self._header is not None:
                parent._header = self._header
        else:
            parent._apply_delta(self._delta, self._header)
        self._finish()

    def rollback(self) -> None:
        if not self._open:
            return  # idempotent; must NOT detach a sibling's registration
        if self._child is not None:
            self._child.rollback()
        self._finish()

    def _finish(self) -> None:
        assert self._open, "LedgerTxn finished twice"
        self._open = False
        self._parent._detach_child()
        self._delta = {}
        self._header = None

    def _assert_open_no_child(self) -> None:
        if not self._open:
            raise LedgerTxnError("LedgerTxn is closed")
        if self._child is not None:
            raise LedgerTxnError("LedgerTxn has an active child (sealed)")

    # -- delta inspection (LedgerManager uses this to feed the bucket list
    #    and emit meta; reference: LedgerTxn::getChanges / getDelta) --------
    def delta(self) -> Dict[bytes, Optional[LedgerEntry]]:
        return dict(self._delta)
