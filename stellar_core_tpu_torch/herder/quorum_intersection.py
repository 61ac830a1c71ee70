"""Quorum intersection checker — CPU branch-and-bound oracle.

Determines whether every two quorums of the observed network configuration
intersect (an NP-hard subset-enumeration problem), and if not produces the
two disjoint quorums as a witness.

Reference: src/herder/QuorumIntersectionChecker.h —
QuorumIntersectionChecker::create; src/herder/QuorumIntersectionCheckerImpl
.{h,cpp} — QuorumIntersectionCheckerImpl, MinQuorumEnumerator, QBitSet,
TarjanSCCCalculator (src/util).  Re-designed for this framework: node sets
are arbitrary-width Python int bitmasks (the reference uses fixed-width
QBitSet over a bitset library); the enumeration is the same
committed/remaining branch-and-bound over minimal quorums with
max-quorum-contraction pruning.  The CUDA enumerator in accel/quorum.py
shares the flattened two-level bitmask encoding produced by
:func:`flatten_qmap`, leans on this module for the SCC phase and re-checks
every split witness the card reports on it.

The copy of stellar_core_tpu/herder/quorum_intersection.py.  What differs
is how the native enumeration core (native/cquorum.c) loads: the port
builds it at first use with the host C compiler (``_native_build``),
as it builds ``_cxdr`` and ``_capply``; where the build fails, or
STELLAR_TPU_NO_CQUORUM is set, ``check()`` runs the Python enumeration,
as the reference does without ``_cquorum``.

Algorithm facts (same as the reference):
 - every minimal quorum is strongly connected in the dependency graph
   (node -> nodes named by its qset), so if two distinct SCCs each contain
   a quorum the network trivially splits, and otherwise enumeration can be
   restricted to the unique "main" SCC that contains quorums;
 - the network has disjoint quorums iff some *minimal* quorum has a quorum
   inside its complement, so it suffices to enumerate minimal quorums.
"""

from __future__ import annotations

import os as _os
import struct as _struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# Native enumeration core (native/cquorum.c — the framework's equivalent
# of the reference's native C++ checker, SURVEY §2.4).  The pure-Python
# methods below stay the semantic source of truth; the C core is a
# faithful port differentially tested to produce identical verdicts,
# split witnesses and max_quorums_found.  Set STELLAR_TPU_NO_CQUORUM to
# force the pure-Python enumeration (the differential test does).
try:
    if _os.environ.get("STELLAR_TPU_NO_CQUORUM"):
        raise ImportError("cquorum disabled by STELLAR_TPU_NO_CQUORUM")
    from .. import _native_build
    _cquorum = _native_build.load("_cquorum")
except ImportError:
    _cquorum = None

NodeIDb = bytes


class InterruptedError_(Exception):
    """Raised inside the enumeration when the interrupt flag is set.
    Reference: QuorumIntersectionChecker — InterruptedException."""


# ---------------------------------------------------------------------------
# Bitmask quorum-set encoding
# ---------------------------------------------------------------------------

@dataclass
class QBitSet:
    """A quorum set over node indexes, encoded as bitmasks.

    Reference: QuorumIntersectionCheckerImpl.h — QBitSet (threshold,
    nodes bitset, innerSets, successors cache).
    """
    threshold: int
    nodes: int                      # bitmask of direct validator members
    inner: List["QBitSet"] = field(default_factory=list)
    successors: int = 0             # nodes | union of inner successors

    @staticmethod
    def build(threshold: int, nodes: int, inner: List["QBitSet"]) -> "QBitSet":
        succ = nodes
        for i in inner:
            succ |= i.successors
        return QBitSet(threshold, nodes, inner, succ)


def qset_to_qbitset(qset, index: Dict[NodeIDb, int]) -> QBitSet:
    """Convert an xdr SCPQuorumSet to a QBitSet using `index` (node id ->
    bit position).  Unknown validators (not in the quorum map) are dropped
    from the mask but still count against the threshold, mirroring the
    reference's treatment of unknown nodes as permanently failed."""
    mask = 0
    for v in qset.validators:
        bit = index.get(v.value)
        if bit is not None:
            mask |= 1 << bit
    inner = [qset_to_qbitset(i, index) for i in qset.innerSets]
    return QBitSet.build(qset.threshold, mask, inner)


def slice_satisfied(qb: QBitSet, mask: int) -> bool:
    """True iff `mask` contains at least one slice of qb."""
    count = (qb.nodes & mask).bit_count()
    if count >= qb.threshold:
        return True
    for i in qb.inner:
        if slice_satisfied(i, mask):
            count += 1
            if count >= qb.threshold:
                return True
    return False


# ---------------------------------------------------------------------------
# Tarjan SCC over the qset dependency graph
# ---------------------------------------------------------------------------

def tarjan_sccs(succs: Sequence[int], n: int) -> List[int]:
    """SCCs of the graph node i -> bits of succs[i], as bitmasks.
    Reference: src/util/TarjanSCCCalculator.{h,cpp} (iterative here; the
    reference recursion overflows for no reason we need to copy)."""
    index = [0] * n
    low = [0] * n
    on_stack = [False] * n
    visited = [False] * n
    stack: List[int] = []
    sccs: List[int] = []
    counter = [1]

    for root in range(n):
        if visited[root]:
            continue
        # iterative DFS: work items (node, iterator state via child bit list)
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                visited[v] = True
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            m = succs[v] >> pi
            while m:
                if m & 1:
                    w = pi
                    if not visited[w]:
                        work[-1] = (v, pi + 1)
                        work.append((w, 0))
                        advanced = True
                        break
                    elif on_stack[w]:
                        low[v] = min(low[v], index[w])
                m >>= 1
                pi += 1
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                scc = 0
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc |= 1 << w
                    if w == v:
                        break
                sccs.append(scc)
            if work:
                p, _ = work[-1]
                low[p] = min(low[p], low[v])
    return sccs


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------

@dataclass
class QuorumIntersectionResult:
    intersects: bool
    # On failure: the two disjoint quorums, as node-id lists.
    split: Optional[Tuple[List[NodeIDb], List[NodeIDb]]] = None
    # Diagnostics
    node_count: int = 0
    main_scc_size: int = 0
    max_quorums_found: int = 0


class QuorumIntersectionChecker:
    """Exact intersection check over a quorum map {node_id: SCPQuorumSet}.

    Reference: QuorumIntersectionCheckerImpl::networkEnumerateAndCheck
    MinQuorums.  `interrupt` is a zero-arg callable polled inside the
    enumeration (reference: std::atomic<bool>& interruptFlag).
    """

    def __init__(self, qmap: Dict[NodeIDb, object],
                 interrupt: Optional[Callable[[], bool]] = None):
        # Nodes with no known qset are treated as failed (excluded) but
        # still referenced by others' masks as absent bits.
        self.node_ids: List[NodeIDb] = sorted(n for n, q in qmap.items()
                                              if q is not None)
        self.index: Dict[NodeIDb, int] = {n: i
                                          for i, n in enumerate(self.node_ids)}
        self.n = len(self.node_ids)
        self.qbs: List[QBitSet] = [qset_to_qbitset(qmap[nid], self.index)
                                   for nid in self.node_ids]
        self.interrupt = interrupt or (lambda: False)
        self.max_quorums_found = 0

    # -- quorum primitives over bitmasks ---------------------------------
    def contract_to_max_quorum(self, mask: int) -> int:
        """Greatest quorum contained in `mask`, or 0.
        Reference: QuorumIntersectionCheckerImpl::contractToMaximalQuorum."""
        while True:
            new = 0
            m = mask
            while m:
                bit = m & -m
                i = bit.bit_length() - 1
                if slice_satisfied(self.qbs[i], mask):
                    new |= bit
                m ^= bit
            if new == mask:
                return mask
            mask = new

    def is_quorum(self, mask: int) -> bool:
        return mask != 0 and self.contract_to_max_quorum(mask) == mask

    def is_minimal_quorum(self, mask: int) -> bool:
        """No proper subset of `mask` is a quorum.  It suffices to drop each
        single member and contract.  Reference: MinQuorumEnumerator —
        hasDisjointQuorum path checks via isMinimalQuorum."""
        m = mask
        while m:
            bit = m & -m
            if self.contract_to_max_quorum(mask & ~bit):
                return False
            m ^= bit
        return True

    # -- enumeration ------------------------------------------------------
    def _check_interrupt(self) -> None:
        if self.interrupt():
            raise InterruptedError_()

    def _pick_split_node(self, remaining: int) -> int:
        """Branch on the highest-in-degree remaining node (helps pruning —
        same heuristic family as the reference's pickSplitNode, which picks
        the max-indegree node of the remaining graph)."""
        best, best_deg = 0, -1
        m = remaining
        while m:
            bit = m & -m
            i = bit.bit_length() - 1
            deg = (self._indegree[i])
            if deg > best_deg:
                best, best_deg = bit, deg
            m ^= bit
        return best

    def _enumerate(self, committed: int, remaining: int,
                   scc: int) -> Optional[Tuple[int, int]]:
        """Find a minimal quorum inside committed|remaining that contains
        `committed` and whose complement (within scc) contains a quorum.
        Returns (min_quorum, disjoint_quorum) or None.
        Reference: MinQuorumEnumerator::anyMinQuorumHasDisjointQuorum."""
        self._check_interrupt()
        perimeter = committed | remaining
        mq = self.contract_to_max_quorum(perimeter)
        if committed & ~mq:
            return None                 # committed can't be inside any quorum here
        if not mq:
            return None
        if committed and self.is_quorum(committed):
            # Any further descent only yields supersets => non-minimal.
            self.max_quorums_found += 1
            if self.is_minimal_quorum(committed):
                disjoint = self.contract_to_max_quorum(scc & ~committed)
                if disjoint:
                    return (committed, disjoint)
            return None
        if not remaining:
            return None
        bit = self._pick_split_node(remaining)
        rest = remaining & ~bit
        # exclude-first order mirrors the reference (explores small quorums
        # of the rest before committing the split node)
        r = self._enumerate(committed, rest, scc)
        if r is not None:
            return r
        return self._enumerate(committed | bit, rest, scc)

    def check(self) -> QuorumIntersectionResult:
        """Run the full check.  Reference call path: HerderImpl::
        checkAndMaybeReanalyzeQuorumMap -> QuorumIntersectionChecker::create
        -> networkEnumerateAndCheckMinQuorums.  Dispatches to the native
        enumeration core when available (n <= 128 bitmask width); the
        pure-Python enumeration below is the fallback and the semantic
        source of truth."""
        if _cquorum is not None and 0 < self.n <= 128:
            try:
                return self._check_native()
            except ValueError:
                # The native parser enforces bounds (e.g. >4096 inner sets)
                # that the Python enumeration — the semantic source of
                # truth — handles fine; degrade rather than refuse.
                pass
        return self._check_python()

    def _blob(self) -> bytes:
        """Serialize the qset forest for the native core (little-endian:
        u32 n, then per node u32 threshold / 16-byte mask / u32 n_inner /
        children recursively)."""
        out = [_struct.pack("<I", self.n)]

        def ser(qb: QBitSet) -> None:
            out.append(_struct.pack("<I", qb.threshold))
            out.append(qb.nodes.to_bytes(16, "little"))
            out.append(_struct.pack("<I", len(qb.inner)))
            for i in qb.inner:
                ser(i)

        for qb in self.qbs:
            ser(qb)
        return b"".join(out)

    def _check_native(self) -> QuorumIntersectionResult:
        code, a, b, main_scc_size, max_q = _cquorum.check(
            self._blob(), self.interrupt)
        if code == -1:
            raise InterruptedError_()
        self.max_quorums_found = max_q
        if code == 1:
            return QuorumIntersectionResult(
                True, node_count=self.n, main_scc_size=main_scc_size,
                max_quorums_found=max_q)
        return QuorumIntersectionResult(
            False,
            split=(self._names(int.from_bytes(a, "little")),
                   self._names(int.from_bytes(b, "little"))),
            node_count=self.n, main_scc_size=main_scc_size,
            max_quorums_found=max_q)

    def _check_python(self) -> QuorumIntersectionResult:
        n = self.n
        if n == 0:
            return QuorumIntersectionResult(True, node_count=0)

        # in-degree for the split heuristic
        self._indegree = [0] * n
        for qb in self.qbs:
            m = qb.successors
            while m:
                bit = m & -m
                self._indegree[bit.bit_length() - 1] += 1
                m ^= bit

        sccs = tarjan_sccs([qb.successors for qb in self.qbs], n)
        quorum_sccs = []
        for scc in sccs:
            mq = self.contract_to_max_quorum(scc)
            if mq:
                quorum_sccs.append((scc, mq))
        if not quorum_sccs:
            # No quorum anywhere: vacuously intersecting (reference reports
            # "no quorums found" and treats as enjoying intersection).
            return QuorumIntersectionResult(True, node_count=n,
                                            main_scc_size=0)
        if len(quorum_sccs) > 1:
            (_, q1), (_, q2) = quorum_sccs[0], quorum_sccs[1]
            return QuorumIntersectionResult(
                False, split=(self._names(q1), self._names(q2)),
                node_count=n, main_scc_size=0)
        scc, _ = quorum_sccs[0]
        r = self._enumerate(0, scc, scc)
        result = QuorumIntersectionResult(
            r is None,
            split=None if r is None else (self._names(r[0]),
                                          self._names(r[1])),
            node_count=n,
            main_scc_size=scc.bit_count(),
            max_quorums_found=self.max_quorums_found)
        return result

    def _names(self, mask: int) -> List[NodeIDb]:
        out = []
        m = mask
        while m:
            bit = m & -m
            out.append(self.node_ids[bit.bit_length() - 1])
            m ^= bit
        return out


def _try_symmetric_org_contraction(qmap: Dict[NodeIDb, object]
                                   ) -> Optional[QuorumIntersectionResult]:
    """Tier-1-shaped fast path: when EVERY node shares one identical qset
    of the form `t of k disjoint flat inner sets (orgs) covering exactly
    the node set`, the validator-level question contracts to the org level
    (the symmetric-cluster contraction from the FBAS analysis literature;
    the real pubnet tier-1 has exactly this shape).

    Soundness: all nodes share qset Q, so U is a quorum iff the orgs
    satisfied by U (>= thr_o members present) satisfy Q's outer threshold.
    - If the org-level projection (k flat nodes, threshold t) enjoys
      intersection, any two quorums share an org o; with 2*thr_o > n_o two
      thr_o-subsets of o must overlap, so the quorums intersect.
    - If the org-level projection splits, taking thr_o members per org on
      each side yields two disjoint validator-level quorums.
    Requires 2*thr_o > n_o for every org; returns None (fall back to full
    enumeration) when any condition fails."""
    values = list(qmap.values())  # corelint: disable=iteration-order -- all-equal homogeneity check, order-free
    if not values or any(q is None for q in values):
        return None  # nodes with unknown qsets: full checker handles them
    first = values[0]
    first_xdr = first.to_xdr()
    if any(q.to_xdr() != first_xdr for q in values[1:]):
        return None
    if first.validators or not first.innerSets:
        return None
    orgs: List[Tuple[int, List[NodeIDb]]] = []
    seen: Set[NodeIDb] = set()
    for inner in first.innerSets:
        if inner.innerSets or not inner.validators:
            return None
        members = [v.value for v in inner.validators]
        if len(set(members)) != len(members):
            return None  # duplicate members within an org
        if any(m in seen or m not in qmap for m in members):
            return None
        seen.update(members)
        if not 0 < inner.threshold <= len(members):
            return None  # unsatisfiable / degenerate org
        if 2 * inner.threshold <= len(members):
            return None  # two minimal org picks may not overlap
        orgs.append((inner.threshold, members))
    if seen != set(qmap):
        return None

    # the projection is always flat `t of k orgs` here (guaranteed by the
    # shape checks above), so org-level intersection has a closed form:
    # two org quorums of size >= t overlap iff 2t > k
    k = len(orgs)
    t = first.threshold
    if not 1 <= t <= k:
        return None
    if 2 * t > k:
        return QuorumIntersectionResult(
            True, node_count=len(qmap), main_scc_size=len(qmap))
    # split witness: thr_o members from each of the first t orgs vs the
    # last t orgs (disjoint because 2t <= k)
    side_a: List[NodeIDb] = []
    side_b: List[NodeIDb] = []
    for thr, members in orgs[:t]:
        side_a.extend(members[:thr])
    for thr, members in orgs[k - t:]:
        side_b.extend(members[:thr])
    return QuorumIntersectionResult(
        False, split=(side_a, side_b), node_count=len(qmap),
        main_scc_size=len(qmap))


def check_intersection(qmap: Dict[NodeIDb, object],
                       interrupt: Optional[Callable[[], bool]] = None
                       ) -> QuorumIntersectionResult:
    """Convenience one-shot API (reference: QuorumIntersectionChecker::
    create(...)->networkEnumerateAndCheckMinQuorums()).  Applies the
    symmetric-org contraction when the topology allows (pubnet tier-1
    shape: the exact enumeration is exponential in orgs; the contraction
    answers at org granularity), falling back to full branch-and-bound."""
    contracted = _try_symmetric_org_contraction(qmap)
    if contracted is not None:
        return contracted
    return QuorumIntersectionChecker(qmap, interrupt).check()


# ---------------------------------------------------------------------------
# Critical-groups analysis
# ---------------------------------------------------------------------------

def project_out_faulty(qset, faulty: Set[NodeIDb]):
    """Project a qset onto the honest nodes, under the model that `faulty`
    nodes vote for anything: each faulty validator is removed AND counts as
    an automatic threshold hit (threshold decremented); an inner set whose
    projected threshold reaches 0 is auto-satisfied and likewise becomes a
    threshold hit on its parent.  A resulting threshold of 0 means the
    node's slices can be satisfied by faulty nodes alone."""
    from ..xdr import scp as SX
    thr = qset.threshold
    validators = []
    for v in qset.validators:
        if v.value in faulty:
            thr -= 1
        else:
            validators.append(v)
    inner = []
    for i in qset.innerSets:
        pi = project_out_faulty(i, faulty)
        if pi.threshold <= 0:
            thr -= 1
        else:
            inner.append(pi)
    return SX.SCPQuorumSet(threshold=max(thr, 0), validators=validators,
                           innerSets=inner)


def intersection_critical_groups(
        qmap: Dict[NodeIDb, object],
        groups: Sequence[Set[NodeIDb]],
        interrupt: Optional[Callable[[], bool]] = None
        ) -> List[Set[NodeIDb]]:
    """Which of `groups` are intersection-critical: groups whose nodes, if
    they turned Byzantine, would break quorum intersection *among the honest
    nodes*.  Model: two original-system quorums intersecting only inside the
    faulty group is a split, which is equivalent to checking intersection of
    the honest-projected system (faulty nodes deleted from every slice with
    thresholds decremented — they vote for both halves).

    Reference: QuorumIntersectionChecker::getIntersectionCriticalGroups
    (the reference auto-derives candidate groups from homonymous orgs; here
    the caller supplies the grouping, and the CLI groups by qset equality).
    """
    critical: List[Set[NodeIDb]] = []
    for group in groups:
        faulty = set(group)
        honest_map = {n: (project_out_faulty(q, faulty)
                          if q is not None else None)
                      for n, q in qmap.items() if n not in faulty}
        res = check_intersection(honest_map, interrupt)
        if not res.intersects:
            critical.append(set(group))
    return critical


# ---------------------------------------------------------------------------
# Flattened two-level encoding shared with the CUDA enumerator
# ---------------------------------------------------------------------------

def flatten_qmap(qmap: Dict[NodeIDb, object]):
    """Flatten a quorum map to the fixed two-level form consumed by
    accel/quorum.py: per node, a top threshold, a direct-validator bitmask
    and K inner (threshold, bitmask) pairs.  Returns (node_ids, tops,
    top_masks, inner_thrs, inner_masks) with Python-int masks; deeper
    nesting (rare; reference caps at MAXIMUM_QUORUM_NESTING_LEVEL=4) is
    rejected with ValueError so callers fall back to the CPU oracle."""
    node_ids = sorted(n for n, q in qmap.items() if q is not None)
    index = {n: i for i, n in enumerate(node_ids)}
    tops, top_masks, inner_thrs, inner_masks = [], [], [], []
    for nid in node_ids:
        qb = qset_to_qbitset(qmap[nid], index)
        for i in qb.inner:
            if i.inner:
                raise ValueError("qset nesting deeper than 2 levels; "
                                 "the CUDA path requires the flattened org form")
        tops.append(qb.threshold)
        top_masks.append(qb.nodes)
        inner_thrs.append([i.threshold for i in qb.inner])
        inner_masks.append([i.nodes for i in qb.inner])
    return node_ids, tops, top_masks, inner_thrs, inner_masks
