"""LocalNode — this node's identity + quorum set, and the federated-voting
primitives evaluated against a map of latest statements.

Reference: src/scp/LocalNode.{h,cpp} — getNodeWeight, federatedAccept/
federatedRatify live on Slot in the reference; here they sit with the node
since they only need the local qset + a statement map.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Set

from . import quorum as Q

UINT64_MAX = (1 << 64) - 1


class LocalNode:
    def __init__(self, node_id: bytes, qset, is_validator: bool = True):
        self.node_id = node_id
        self.qset = qset
        self.qset_hash = Q.qset_hash(qset)
        self.is_validator = is_validator

    def update_qset(self, qset) -> None:
        self.qset = qset
        self.qset_hash = Q.qset_hash(qset)

    # --- leader-election weight ------------------------------------------
    def node_weight(self, node_id: bytes, qset=None) -> int:
        """Fraction of slices containing node_id, in units of 2^64-1.
        Reference: LocalNode::getNodeWeight (bigDivide, round-down)."""
        qset = qset if qset is not None else self.qset
        n = len(qset.validators) + len(qset.innerSets)
        t = qset.threshold
        for v in qset.validators:
            if v.value == node_id:
                return UINT64_MAX * t // n
        for inner in qset.innerSets:
            w = self.node_weight(node_id, inner)
            if w:
                return w * t // n
        return 0

    # --- federated voting -------------------------------------------------
    def federated_accept(self, voted: Callable[[object], bool],
                         accepted: Callable[[object], bool],
                         stmt_map: Dict[bytes, object],
                         qset_of: Callable[[object], Optional[object]],
                         index=None, key=None, latch: bool = False) -> bool:
        """vote→accept: a v-blocking set accepted it, or a quorum voted-or-
        accepted it.

        `index`/`key`/`latch`: per-slot incremental quorum state (see
        quorum.StatementIndex) — the whole verdict is memoized under the
        statement-map epoch, and `latch=True` (monotone predicates only:
        nomination votes) pins a True verdict for the slot."""
        k = None
        if index is not None and key is not None:
            k = ("fa", key, self.qset_hash)
            got = index.lookup(k)
            if got is not None:
                return got
        accepted_nodes = {n for n, st in stmt_map.items() if accepted(st)}
        if Q.is_v_blocking_compiled(Q.compile_qset_cached(self.qset),
                                    accepted_nodes):
            res = True
        else:
            res = Q.is_quorum(self.qset, stmt_map, qset_of,
                              lambda st: voted(st) or accepted(st),
                              index=index)
        if k is not None:
            index.store(k, res, latch)
        return res

    def federated_ratify(self, voted: Callable[[object], bool],
                         stmt_map: Dict[bytes, object],
                         qset_of: Callable[[object], Optional[object]],
                         index=None, key=None, latch: bool = False) -> bool:
        """accept→confirm: a quorum accepted it."""
        k = None
        if index is not None and key is not None:
            k = ("fr", key, self.qset_hash)
            got = index.lookup(k)
            if got is not None:
                return got
        res = Q.is_quorum(self.qset, stmt_map, qset_of, voted, index=index)
        if k is not None:
            index.store(k, res, latch)
        return res

    def is_v_blocking(self, nodes: Set[bytes]) -> bool:
        return Q.is_v_blocking_compiled(Q.compile_qset_cached(self.qset),
                                        nodes)

    # --- set-based fast paths ---------------------------------------------
    # Callers that maintain per-value voter registries incrementally
    # (nomination: vote sets only grow, so each envelope contributes its
    # DELTA) pass materialized node sets instead of predicates — the
    # per-call O(n) statement sweep was the last n^2 term per envelope
    # at 300 simulated nodes.  Verdicts are memoized/latched through the
    # same StatementIndex discipline as the predicate forms.
    def federated_accept_sets(self, voted_nodes: Set[bytes],
                              accepted_nodes: Set[bytes],
                              index, key, latch: bool = False) -> bool:
        k = ("fa", key, self.qset_hash)
        got = index.lookup(k)
        if got is not None:
            return got
        if Q.is_v_blocking_compiled(Q.compile_qset_cached(self.qset),
                                    accepted_nodes):
            res = True
        else:
            res = Q.quorum_contains(self.qset,
                                    voted_nodes | accepted_nodes,
                                    index.node_cq)
        index.store(k, res, latch)
        return res

    def federated_ratify_sets(self, accepted_nodes: Set[bytes],
                              index, key, latch: bool = False) -> bool:
        k = ("fr", key, self.qset_hash)
        got = index.lookup(k)
        if got is not None:
            return got
        res = Q.quorum_contains(self.qset, accepted_nodes, index.node_cq)
        index.store(k, res, latch)
        return res
