"""FutureBucket: a handle on an in-progress (or finished) bucket merge.

Reference: src/bucket/FutureBucket.{h,cpp} — the reference runs level merges
on worker threads and resolves the future lazily at the next spill boundary
("commit"), so merge compute overlaps ledger closes.  The HAS serializes a
level's pending merge as ``next``: ``{"state": 0}`` when clear or
``{"state": 1, "output": <hex>}`` once resolved (FB_HASH_OUTPUT), which is
how a restarted / catching-up node reconstructs the exact same future bucket
lineage and therefore the exact same subsequent bucket-list hashes.

Merges are pure functions of their inputs, so resolution order/threading
never changes the output — sync mode (no executor) and threaded mode are
bit-identical, which the test suite asserts.  With a ``raw_store`` the
merge runs as ``merge_buckets_raw``: records stream file-to-file without
decoding (reference: BucketBase::merge between Bucket*Iterators) and the
output is a disk-resident bucket — same hash, O(1) merge memory.
"""

from __future__ import annotations

from typing import Optional

from ..util import perf
from ..util.metrics import registry as _registry
from .bucket import Bucket, merge_buckets, merge_buckets_raw

# deep-level merges run minutes on big ledgers, by design, in the
# background — only a pathological merge deserves a slow-scope warning
perf.set_slow_threshold("bucket.merge.time", 120.0)
perf.set_slow_threshold("bucket.merge.stream", 120.0)


def _timed_merge(curr: Bucket, snap: Bucket, keep_tombstones: bool,
                 protocol_version: int) -> Bucket:
    """merge_buckets with the bucket.merge.time timer (reference: the
    "bucket.merge" medida timers in BucketManagerImpl) — runs on whichever
    thread executes the merge, so background merges are timed too."""
    with perf.scoped_timer("bucket.merge.time"):
        return merge_buckets(curr, snap, keep_tombstones, protocol_version)


def _timed_merge_raw(curr: Bucket, snap: Bucket, keep_tombstones: bool,
                     protocol_version: int, store) -> Bucket:
    """merge_buckets_raw under the bucket.merge.stream timer, with the
    output volume marked on the bucket.merge.bytes meter (merged-bytes/s
    is the streaming pipeline's throughput signal)."""
    with perf.scoped_timer("bucket.merge.stream"):
        out = merge_buckets_raw(curr, snap, keep_tombstones,
                                protocol_version, store)
    idx = out.disk_index()
    if idx is not None:
        _registry().meter("bucket.merge.bytes").mark(idx._file_size)
    return out


class FutureBucket:
    """Either a running merge (executor future) or a resolved output.

    Inputs are retained until resolution so an unresolved merge can be
    serialized as FB_HASH_INPUTS (curr/snap hashes + merge params) in the
    node's durable HAS — restart then re-runs the merge from inputs instead
    of the close path having to block on resolve() every ledger."""

    __slots__ = ("_future", "_output", "inputs", "_raw_store")

    def __init__(self, curr: Bucket, snap: Bucket, keep_tombstones: bool,
                 protocol_version: int, executor=None, raw_store=None):
        self._output: Optional[Bucket] = None
        self._future = None
        self.inputs = (curr, snap, keep_tombstones, protocol_version)
        self._raw_store = raw_store
        if raw_store is not None:
            fn, args = _timed_merge_raw, (curr, snap, keep_tombstones,
                                          protocol_version, raw_store)
        else:
            fn, args = _timed_merge, (curr, snap, keep_tombstones,
                                      protocol_version)
        if executor is not None:
            self._future = executor.submit(fn, *args)
        else:
            self._output = fn(*args)

    @staticmethod
    def from_output(bucket: Bucket) -> "FutureBucket":
        """Rehydrate a future from its serialized output hash (HAS state 1,
        reference: FutureBucket::makeLive on the FB_HASH_OUTPUT path)."""
        fb = FutureBucket.__new__(FutureBucket)
        fb._future = None
        fb._output = bucket
        fb.inputs = None
        fb._raw_store = None
        return fb

    @property
    def done(self) -> bool:
        return self._output is not None or self._future.done()

    def resolve(self) -> Bucket:
        """Block until the merge output is available and return it."""
        if self._output is None:
            self._output = self._future.result()
            self._future = None
        return self._output

    def peek(self) -> Optional[Bucket]:
        """The output if already materialized on THIS handle, else None —
        never blocks (resident-entry accounting must not sync a running
        background merge)."""
        return self._output

    def release_output_pin(self) -> None:
        """Drop the streaming-merge output's GC pin (taken by the store at
        stream adoption).  Called by BucketLevel.commit once the output is
        referenced as the level's curr; no-op for in-memory merges."""
        if self._raw_store is not None and self._output is not None:
            store, self._raw_store = self._raw_store, None
            if not self._output.is_empty():
                store.unpin([self._output.hash().hex()])

    def serialize(self) -> dict:
        """The HAS `next` form (reference: FutureBucket::save): output hash
        when already resolved, inputs otherwise — never blocks."""
        if self.done:
            return {"state": 1, "output": self.resolve().hash().hex()}
        curr, snap, keep, proto = self.inputs
        return {"state": 2, "curr": curr.hash().hex(),
                "snap": snap.hash().hex(), "keepTombstones": keep,
                "outputProtocol": proto}
