"""Quorum intersection checker -- the CPU branch-and-bound oracle.

The port's own copy of ``stellar_core_tpu/herder/quorum_intersection.py``:
``InterruptedError_``, ``QBitSet``, ``qset_to_qbitset``,
``slice_satisfied``, ``tarjan_sccs``, ``QuorumIntersectionResult``, the
pure-Python ``QuorumIntersectionChecker`` and ``flatten_qmap``, unchanged.
The CUDA enumerator (``accel/quorum.py``) leans on it for the SCC phase and
re-checks every split witness the card reports on it.

Left out: the native ``_cquorum`` engine (a C extension built for the JAX
package; ``check()`` here always runs the Python enumeration), and the
functions that need the XDR codec (``_try_symmetric_org_contraction``,
``check_intersection``, ``project_out_faulty``,
``intersection_critical_groups``).

Algorithm facts (same as the reference):
 - every minimal quorum is strongly connected in the dependency graph
   (node -> nodes named by its qset), so if two distinct SCCs each contain
   a quorum the network trivially splits, and otherwise enumeration can be
   restricted to the unique "main" SCC that contains quorums;
 - the network has disjoint quorums iff some *minimal* quorum has a quorum
   inside its complement, so it suffices to enumerate minimal quorums.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
        -> networkEnumerateAndCheckMinQuorums."""
        return self._check_python()

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
