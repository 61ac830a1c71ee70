"""Quorum-set logic: slices, v-blocking sets, transitive quorum discovery.

Reference: src/scp/LocalNode.{h,cpp} — LocalNode::{isQuorumSlice, isVBlocking,
isQuorum, forAllNodes}; src/scp/QuorumSetUtils.{h,cpp} — isQuorumSetSane,
normalizeQSet.  Re-designed as free functions over frozen node-id sets (the
CUDA quorum-intersection enumerator in accel/quorum.py shares the same bitmask
encoding produced by QGraph below).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Set

from ..crypto.sha import sha256
from ..xdr import scp as SX

# Node ids are the raw 32-byte ed25519 key (hashable); X.NodeID <-> bytes
# conversion happens at the SCP envelope boundary (slot.py).
NodeIDb = bytes

MAX_NESTING_LEVEL = 4  # reference: QuorumSetUtils.cpp — MAXIMUM_QUORUM_NESTING_LEVEL


def qset_hash(qset) -> bytes:
    """SHA-256 of the XDR encoding (content address used in SCP statements)."""
    return sha256(qset.to_xdr())


def statement_qset_hash(st) -> bytes:
    """The quorum-set hash a statement pledges under (every pledge type
    carries one)."""
    pl = st.pledges
    t = pl.type
    if t == SX.SCPStatementType.SCP_ST_NOMINATE:
        return pl.nominate.quorumSetHash
    if t == SX.SCPStatementType.SCP_ST_PREPARE:
        return pl.prepare.quorumSetHash
    if t == SX.SCPStatementType.SCP_ST_CONFIRM:
        return pl.confirm.quorumSetHash
    return pl.externalize.commitQuorumSetHash


def for_all_nodes(qset, fn: Callable[[NodeIDb], None]) -> None:
    for v in qset.validators:
        fn(v.value)
    for inner in qset.innerSets:
        for_all_nodes(inner, fn)


def qset_nodes(qset) -> Set[NodeIDb]:
    out: Set[NodeIDb] = set()
    for_all_nodes(qset, out.add)
    return out


def is_quorum_slice(qset, nodes: Set[NodeIDb]) -> bool:
    """True iff `nodes` contains at least one slice of `qset`."""
    count = 0
    for v in qset.validators:
        if v.value in nodes:
            count += 1
    for inner in qset.innerSets:
        if is_quorum_slice(inner, nodes):
            count += 1
    return count >= qset.threshold


def is_v_blocking(qset, nodes: Set[NodeIDb]) -> bool:
    """True iff `nodes` intersects every slice of `qset` (can block quorum)."""
    if qset.threshold == 0:
        return False
    left = len(qset.validators) + len(qset.innerSets) - qset.threshold + 1
    for v in qset.validators:
        if v.value in nodes:
            left -= 1
            if left <= 0:
                return True
    for inner in qset.innerSets:
        if is_v_blocking(inner, nodes):
            left -= 1
            if left <= 0:
                return True
    return False


def is_v_blocking_compiled(cq: tuple, nodes: Set[NodeIDb]) -> bool:
    """is_v_blocking over a compile_qset form — the v-blocking arm of
    every federated_accept runs per envelope, and the XDR descriptor walk
    was the last per-envelope qset traversal left after the round-11
    slice compilation (same move as _compiled_slice_ok)."""
    threshold, validators, inners = cq
    if threshold == 0:
        return False
    left = len(validators) + len(inners) - threshold + 1
    for v in validators:
        if v in nodes:
            left -= 1
            if left <= 0:
                return True
    for inner in inners:
        if is_v_blocking_compiled(inner, nodes):
            left -= 1
            if left <= 0:
                return True
    return False


def compile_qset(qset) -> tuple:
    """Flatten a qset into plain nested tuples ``(threshold,
    (validator_bytes, ...), (inner, ...))`` — slice checks over the
    compiled form skip the per-field XDR descriptor machinery, which
    dominates `is_quorum` wall time on large simulated networks (a
    51-node hierarchical sim spent 21s of a 37s consensus run inside
    `is_quorum_slice` before this)."""
    return (qset.threshold,
            tuple(v.value for v in qset.validators),
            tuple(compile_qset(i) for i in qset.innerSets))


# id(qset) -> (qset, compiled form).  XDR structs are __slots__-bound (no
# per-instance memo field) and hashing the canonical encoding per lookup
# costs more than the walk it would save, so the cache key is the object
# id — made safe by pinning a strong reference to the keyed object in the
# value (an id is only ever reused after its object is collected, and a
# pinned object never is).  SCP treats quorum sets as immutable once
# announced; mutating a cached instance in place would go unseen.
# Bounded: distinct qset instances per process are few (one per herder
# per topology shape), but a long fuzz run must not grow this without
# limit — on overflow the cache is dropped wholesale, unpinning ids.
_COMPILED_CACHE_MAX = 4096
_compiled_cache: Dict[int, tuple] = {}


def compile_qset_cached(qset) -> tuple:
    got = _compiled_cache.get(id(qset))
    if got is not None:
        return got[1]
    if len(_compiled_cache) >= _COMPILED_CACHE_MAX:
        _compiled_cache.clear()
    cq = compile_qset(qset)
    _compiled_cache[id(qset)] = (qset, cq)
    return cq


def _compiled_slice_ok(cq: tuple, nodes: Set[NodeIDb]) -> bool:
    threshold, validators, inners = cq
    if threshold <= 0:
        # is_quorum_slice returns count >= 0 == True for a threshold-0
        # set; the early-exit walk below would return False when no
        # member matches, silently diverging on (insane but legal-to-
        # construct) inputs is_qset_sane never vetted
        return True
    count = 0
    for v in validators:
        if v in nodes:
            count += 1
            if count >= threshold:
                return True
    for inner in inners:
        if _compiled_slice_ok(inner, nodes):
            count += 1
            if count >= threshold:
                return True
    return False


class StatementIndex:
    """Incremental per-slot quorum state (reference: ``Slot``'s cached
    ``mHeardFromQuorum`` edge + ``BallotProtocol::checkHeardFromQuorum``).

    The owning protocol (ballot or nomination) calls ``note_statement``
    every time a node's latest statement is replaced, which keeps three
    incrementally-maintained views the quorum walks would otherwise
    re-derive from XDR on EVERY envelope (the ~n^2 cost that kept the
    300-node soak at offline scale):

    - ``node_counter`` — each node's ballot counter (INT32_MAX for
      EXTERNALIZE, 0 for nominations), replacing a per-envelope
      ``{n: _counter_of(st)}`` rebuild;
    - ``node_cq`` — each node's COMPILED quorum set, replacing the
      per-``is_quorum``-call ``qset_of(stmt)`` + compile lookup per node;
    - a verdict memo keyed by the statement-map **epoch** (bumped on
      every mutation), so repeated quorum questions against an unchanged
      map answer from cache.

    Monotone verdicts (heard-from-quorum at a fixed counter, nomination
    accept/ratify of a fixed value) may additionally be **latched**: once
    True they stay True, because statements only ever get *newer* —
    counters are non-decreasing and nomination vote sets only grow, so a
    satisfied quorum predicate cannot be un-satisfied.  The two events
    that CAN invalidate a latch are handled explicitly: a node changing
    its announced quorum set mid-slot, and a ballot-counter regression
    (possible across a PREPARE→CONFIRM phase edge, and cheap insurance
    against Byzantine statement orderings) — both bump ``qset_epoch``
    and drop every latch, falling back to a full recompute.
    """

    __slots__ = ("epoch", "qset_epoch", "node_counter", "node_cq",
                 "node_qhash", "_memo", "_latched")

    # stale-epoch memo entries never hit; cap the dict so a pathological
    # slot (many candidate ballots) cannot grow it without bound
    MEMO_MAX = 8192

    def __init__(self):
        self.epoch = 0
        self.qset_epoch = 0
        self.node_counter: Dict[NodeIDb, int] = {}
        self.node_cq: Dict[NodeIDb, Optional[tuple]] = {}
        self.node_qhash: Dict[NodeIDb, bytes] = {}
        self._memo: Dict[tuple, tuple] = {}    # key -> (epoch, verdict)
        self._latched: set = set()

    def note_statement(self, node_id: NodeIDb, counter: int,
                       qset, qhash: bytes) -> None:
        """Record that `node_id`'s latest statement is now (counter,
        qset).  `qset` may be None when the referenced set is not yet
        fetched — the quorum walks then skip the node, exactly as the
        uncached path did."""
        self.epoch += 1
        if len(self._memo) > self.MEMO_MAX:
            self._memo.clear()
        pc = self.node_counter.get(node_id)
        oh = self.node_qhash.get(node_id)
        if (pc is not None and counter < pc) or \
                (oh is not None and oh != qhash):
            self.qset_epoch += 1
            self._latched.clear()
        self.node_counter[node_id] = counter
        self.node_cq[node_id] = None if qset is None \
            else compile_qset_cached(qset)
        self.node_qhash[node_id] = qhash

    def lookup(self, key: tuple) -> Optional[bool]:
        if key in self._latched:
            return True
        got = self._memo.get(key)
        if got is not None and got[0] == self.epoch:
            return got[1]
        return None

    def store(self, key: tuple, verdict: bool, latch: bool = False) -> None:
        if latch and verdict:
            self._latched.add(key)
        else:
            self._memo[key] = (self.epoch, verdict)


def quorum_survivors(nodes: Set[NodeIDb],
                     node_cq: Dict[NodeIDb, Optional[tuple]]
                     ) -> Set[NodeIDb]:
    """Transitive fixpoint over compiled qsets: repeatedly drop nodes
    whose own quorum set has no slice inside the surviving set (the core
    of LocalNode::isQuorum).  Nodes sharing one compiled qset share ONE
    slice evaluation per iteration."""
    while True:
        verdicts: Dict[int, bool] = {}
        keep = set()
        for n in nodes:
            cq = node_cq.get(n)
            if cq is None:
                continue
            ok = verdicts.get(id(cq))
            if ok is None:
                ok = verdicts[id(cq)] = _compiled_slice_ok(cq, nodes)
            if ok:
                keep.add(n)
        if keep == nodes:
            return nodes
        nodes = keep


def quorum_contains(local_qset, nodes: Set[NodeIDb],
                    node_cq: Dict[NodeIDb, Optional[tuple]]) -> bool:
    """is_quorum over an ALREADY-MATERIALIZED voting-node set (callers
    that maintain per-value voter registries incrementally skip the
    per-call O(n) predicate sweep entirely)."""
    return _compiled_slice_ok(compile_qset_cached(local_qset),
                              quorum_survivors(set(nodes), node_cq))


def heard_from_quorum(local_qset, local_qset_hash: bytes,
                      index: StatementIndex, min_counter: int) -> bool:
    """Latched heard-from-quorum: do the voting nodes (ballot counter >=
    `min_counter`) contain a transitively-closed quorum with a slice of
    `local_qset`?  Verdicts latch per (counter, local qset) — see
    StatementIndex."""
    key = ("hfq", min_counter, local_qset_hash)
    got = index.lookup(key)
    if got is not None:
        return got
    voted = {n for n, c in index.node_counter.items() if c >= min_counter}
    res = _compiled_slice_ok(compile_qset_cached(local_qset),
                             quorum_survivors(voted, index.node_cq))
    index.store(key, res, latch=True)
    return res


def v_blocking_ahead(local_qset, local_qset_hash: bytes,
                     index: StatementIndex, counter: int) -> bool:
    """Latched counter catch-up check (BallotProtocol::_attempt_bump): is
    a v-blocking set announcing ballot counters >= `counter`?  The
    voting-node set only grows and counters are non-decreasing (a
    regression bumps qset_epoch and drops every latch — see
    StatementIndex), so a True verdict is monotone for the slot and
    latches exactly like heard_from_quorum."""
    key = ("vba", counter, local_qset_hash)
    got = index.lookup(key)
    if got is not None:
        return got
    nodes = {n for n, c in index.node_counter.items() if c >= counter}
    res = is_v_blocking_compiled(compile_qset_cached(local_qset), nodes)
    index.store(key, res, latch=True)
    return res


def is_quorum(local_qset, stmt_map: Dict[NodeIDb, object],
              qset_of: Callable[[object], Optional[object]],
              voted: Callable[[object], bool],
              index: Optional[StatementIndex] = None) -> bool:
    """True iff the nodes whose statement satisfies `voted` contain a quorum
    that includes a slice of local_qset.

    Transitive fixpoint: repeatedly drop nodes whose own quorum set (looked up
    from their statement via `qset_of`) has no slice inside the surviving set.
    Reference: LocalNode::isQuorum.

    Nodes sharing one qset object (the common case: every validator in a
    tier-1-shaped network announces the same hierarchical set) share ONE
    compiled form and ONE slice evaluation per fixpoint iteration instead
    of re-walking the XDR tree per node.

    With an `index` (StatementIndex maintained by the owning protocol),
    each node's compiled qset comes from the incremental per-slot view
    instead of a `qset_of` lookup + compile per node per call.
    """
    nodes = {n for n, st in stmt_map.items() if voted(st)}
    if index is not None:
        node_cq = index.node_cq
    else:
        node_cq = {}
        for n in nodes:
            q = qset_of(stmt_map[n])
            node_cq[n] = None if q is None else compile_qset_cached(q)
    return _compiled_slice_ok(compile_qset_cached(local_qset),
                              quorum_survivors(nodes, node_cq))


def find_closest_v_blocking(qset, nodes: Set[NodeIDb],
                            excluded: Optional[NodeIDb] = None) -> Set[NodeIDb]:
    """A small v-blocking subset of `nodes` w.r.t. qset (greedy heuristic).
    Reference: LocalNode::findClosestVBlocking."""
    left = qset.threshold
    members = []
    for v in qset.validators:
        nid = v.value
        if nid == excluded:
            continue
        if nid in nodes:
            members.append({nid})
        else:
            left -= 1
    for inner in qset.innerSets:
        sub = find_closest_v_blocking(inner, nodes, excluded)
        if sub:
            members.append(sub)
        else:
            left -= 1
    # need to hit (n - threshold + 1) slices; the non-member slots already
    # "hit" themselves by failing.
    needed = len(members) - left + 1
    if needed <= 0:
        return set()
    members.sort(key=len)
    out: Set[NodeIDb] = set()
    for m in members[:needed]:
        out |= m
    return out


def is_qset_sane(qset, extra_checks: bool = False, depth: int = 0) -> bool:
    """Reference: QuorumSetUtils.cpp — isQuorumSetSane.  Thresholds within
    range, nesting bounded, no duplicate nodes."""
    if depth > MAX_NESTING_LEVEL:
        return False
    n = len(qset.validators) + len(qset.innerSets)
    if n == 0 or qset.threshold < 1 or qset.threshold > n:
        return False
    if extra_checks and qset.threshold < 1 + (n + 1) // 2:  # require majority
        return False
    for inner in qset.innerSets:
        if not is_qset_sane(inner, extra_checks, depth + 1):
            return False
    seen: Set[NodeIDb] = set()

    ok = [True]

    def check(nid):
        if nid in seen:
            ok[0] = False
        seen.add(nid)

    for_all_nodes(qset, check)
    return ok[0]


def normalize_qset(qset, remove: Optional[NodeIDb] = None):
    """Flatten trivial inner sets (threshold==n==1) and drop `remove`,
    decrementing the threshold per removed member (removal models "that
    node always agrees", e.g. removing self from the local qset).
    Reference: QuorumSetUtils.cpp — normalizeQSet.  Returns a new qset."""
    validators = []
    threshold = qset.threshold
    for v in qset.validators:
        if v.value == remove:
            threshold -= 1
        else:
            validators.append(v)
    inner = []
    for i in qset.innerSets:
        ni = normalize_qset(i, remove)
        n = len(ni.validators) + len(ni.innerSets)
        if n == 0 or ni.threshold <= 0:
            # inner set auto-satisfied (or emptied) by the removal
            threshold -= 1
            continue
        if ni.threshold == 1 and len(ni.validators) == 1 and not ni.innerSets:
            validators.append(ni.validators[0])
        else:
            inner.append(ni)
    return SX.SCPQuorumSet(threshold=max(threshold, 0), validators=validators,
                           innerSets=inner)


def singleton_qset(node_id: NodeIDb):
    from ..xdr import types as XT
    return SX.SCPQuorumSet(threshold=1, validators=[XT.node_id(node_id)],
                           innerSets=[])
