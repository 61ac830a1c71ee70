"""Footprint scheduler: write-set clustering + parallel batch apply.

Declared footprints make a Soroban phase *declaratively parallelizable*
(PAPER.md §2.2): two transactions whose write sets are disjoint — and
that don't read each other's writes — cannot observe each other, so
they can apply concurrently with serial-equivalent results.

Clustering (union-find over footprint keys):
  * a tx's WRITE set = its footprint readWrite keys + every source
    account it can touch outside the footprint (tx source, fee source,
    per-op sources — seq bumps / one-time-signer removal write those);
  * all writers of a key are unioned;
  * every reader of a key is unioned with that key's writers (a read
    must see the same value it would have seen serially);
  * readers-only of a shared key do NOT union with each other.

Parallel apply reproduces the serial close BYTE-IDENTICALLY (bucket
hashes included).  Two mechanisms make that true:
  1. the footprint-enforcing storage layer guarantees no tx touches
     keys outside its declared sets (out-of-footprint → tx trap);
  2. cluster deltas are merged on the coordinating thread in the exact
     key-insertion order a serial apply would have produced (the close
     delta's dict order feeds the bucket batch, so insertion order is
     consensus-relevant, not cosmetic).

Each cluster applies under a `_ClusterBase` — an AbstractLedgerTxnParent
shim over the shared post-classic-phase LedgerTxn: reads delegate under
a lock, get_header serves a captured copy, and a cluster's commit lands
in a private buffer instead of the shared delta.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..util.lockorder import make_lock

__all__ = ["cluster_footprints", "tx_rw_keys", "apply_clusters_parallel"]


def tx_rw_keys(frame) -> Tuple[frozenset, frozenset]:
    """(write_keys, read_keys) for clustering, as LedgerKey XDR bytes."""
    from ..xdr import account_key_xdr, muxed_to_account_id
    writes = set()
    reads = set()
    writes.add(account_key_xdr(frame.source_account_id().value))
    fee_src = getattr(frame, "fee_source_account_id", None)
    if fee_src is not None:
        writes.add(account_key_xdr(fee_src().value))
    for op in frame.tx.operations:
        if op.sourceAccount is not None:
            writes.add(account_key_xdr(
                muxed_to_account_id(op.sourceAccount).value))
    sd = frame.soroban_data()
    if sd is not None:
        fp = sd.resources.footprint
        for k in fp.readWrite:
            writes.add(k.to_xdr())
        for k in fp.readOnly:
            reads.add(k.to_xdr())
    return frozenset(writes), frozenset(reads)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # root at the smaller index: cluster identity is then the
            # minimum member index — deterministic across runs
            if rb < ra:
                ra, rb = rb, ra
            self.parent[rb] = ra


def cluster_footprints(frames: Sequence) -> List[List]:
    """Partition `frames` (already in canonical apply order) into
    disjoint write-set clusters.  Cluster list is ordered by each
    cluster's first frame; frames keep their relative order."""
    n = len(frames)
    uf = _UnionFind(n)
    writers: Dict[bytes, int] = {}
    rw = [tx_rw_keys(f) for f in frames]
    for i, (writes, _) in enumerate(rw):
        for k in writes:
            if k in writers:
                uf.union(writers[k], i)
            else:
                writers[k] = i
    for i, (_, reads) in enumerate(rw):
        for k in reads:
            if k in writers:
                uf.union(writers[k], i)
    clusters: Dict[int, List] = {}
    for i, f in enumerate(frames):
        clusters.setdefault(uf.find(i), []).append(f)
    return [clusters[root] for root in sorted(clusters)]


class _ClusterBase:
    """AbstractLedgerTxnParent over the shared close LedgerTxn for ONE
    cluster's private LedgerTxn chain.  Reads delegate (locked — the
    underlying root may maintain caches); writes land in
    `self.delta`/`self.header` at commit instead of the shared state.
    Accepts any number of sequential children (the per-tx inner txns
    attach to the CLUSTER ltx, not here, so plain last-wins tracking
    suffices)."""

    def __init__(self, shared_ltx, shared_lock, header):
        self._shared = shared_ltx
        self._lock = shared_lock
        self._header = header
        self.delta: Optional[dict] = None
        self.committed_header = None
        self._child = None

    def get_entry(self, key_bytes: bytes):
        with self._lock:
            return self._shared.get_entry(key_bytes)

    def get_header(self):
        return self._header

    def _attach_child(self, child) -> None:
        self._child = child

    def _detach_child(self) -> None:
        self._child = None

    def all_keys(self):
        with self._lock:
            return iter(list(self._shared.all_keys()))

    def _apply_delta(self, delta: dict, header) -> None:
        # the cluster LedgerTxn's commit() lands here (we are not a
        # LedgerTxn, so commit takes the root-style path)
        self.delta = dict(delta)
        self.committed_header = header


def _apply_cluster(base: "_ClusterBase", cluster: Sequence,
                   apply_fn: Callable, out: dict, idx: int) -> None:
    """Worker: apply one cluster's frames in order against a private
    LedgerTxn over `base`; record per-tx results and the serial
    key-insertion order (first-writer order) for the merge."""
    from ..ledger.ledger_txn import LedgerTxn
    from ..util import detguard
    results = []
    insertion: List[Tuple[int, List[bytes]]] = []
    seen = set()
    try:
        # regions are thread-local: each cluster worker arms its own
        with detguard.region("soroban-cluster"), \
                LedgerTxn(base) as ltx:    # exit without commit == rollback
            for j, frame in enumerate(cluster):
                results.append(apply_fn(frame, ltx))
                new_keys = [k for k in ltx._delta if k not in seen]
                seen.update(new_keys)
                insertion.append((j, new_keys))
            ltx.commit()                   # → base._apply_delta
        out[idx] = (results, base.delta or {}, insertion, None)
    except BaseException as e:  # corelint: disable=exception-hygiene -- captured into `out` and re-raised on the coordinating thread after join
        out[idx] = (None, None, None, e)


def apply_clusters_parallel(shared_ltx, clusters: Sequence[Sequence],
                            apply_fn: Callable, positions: dict):
    """Apply `clusters` concurrently against `shared_ltx` and merge the
    buffered deltas back in serial-equivalent order.

    `apply_fn(frame, ltx)` applies one tx against the cluster's private
    LedgerTxn and returns its result pair.  `positions` maps id(frame)
    to its index in the canonical apply order (drives the merge).
    Returns a dict mapping id(frame) -> result so the caller can
    re-interleave results into the canonical order.  Worker exceptions
    re-raise here (fail-stop — an infrastructure error must never
    half-apply a phase)."""
    shared_lock = make_lock("soroban.cluster-read")
    header = shared_ltx.get_header()
    bases = [_ClusterBase(shared_ltx, shared_lock, header) for _ in clusters]
    out: dict = {}
    threads = []
    for i, cluster in enumerate(clusters):
        t = threading.Thread(
            target=_apply_cluster,
            args=(bases[i], cluster, apply_fn, out, i),
            name=f"soroban-cluster-{i}", daemon=True)
        threads.append(t)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(len(clusters)):
        err = out[i][3]
        if err is not None:
            raise err
    # Serial-equivalent merge: walk txs in canonical order (clusters
    # preserve relative order and the canonical order interleaves them
    # deterministically), inserting each tx's first-written keys in its
    # cluster-local order with the cluster's FINAL value for that key.
    order = sorted(
        ((cluster[j], i, keys)
         for i, cluster in enumerate(clusters)
         for j, keys in out[i][2]),
        key=lambda item: positions[id(item[0])])
    for _frame, i, keys in order:
        final_delta = out[i][1]
        for k in keys:
            shared_ltx._delta[k] = final_delta[k]
    results = {}
    for i, cluster in enumerate(clusters):
        for frame, res in zip(cluster, out[i][0]):
            results[id(frame)] = res
    return results
