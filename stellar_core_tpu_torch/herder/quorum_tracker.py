"""QuorumTracker — the transitive quorum map observed from SCP traffic.

Reference: src/herder/QuorumTracker.{h,cpp} — rebuild/expand: starting from
the local node, walk quorum sets to find every transitively-referenced
node and its latest known qset; feeds /quorum?transitive=true and the
quorum intersection checker (checkAndMaybeReanalyzeQuorumMap).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Set

from ..scp.quorum import qset_nodes


class QuorumTracker:
    def __init__(self, local_node_id: bytes):
        self.local_node_id = local_node_id
        # node id -> qset (None = referenced but qset unknown yet)
        self.quorum_map: Dict[bytes, Optional[object]] = {local_node_id: None}

    def is_node_definitely_in_quorum(self, node_id: bytes) -> bool:
        return node_id in self.quorum_map

    def expand(self, node_id: bytes, qset) -> bool:
        """Record node_id's qset if node_id is already in the transitive
        quorum; returns False if a rebuild is needed (node unknown or qset
        changed).  Reference: QuorumTracker::expand."""
        cur = self.quorum_map.get(node_id, "absent")
        if cur == "absent":
            return False
        if cur is not None and cur is not qset and cur.to_xdr() != qset.to_xdr():
            return False
        self.quorum_map[node_id] = qset
        for n in qset_nodes(qset):
            if n not in self.quorum_map:
                self.quorum_map[n] = None
        return True

    def rebuild(self, lookup: Callable[[bytes], Optional[object]]) -> None:
        """Recompute the full transitive closure from the local node, using
        `lookup` for the latest known qset of each node.
        Reference: QuorumTracker::rebuild."""
        self.quorum_map = {}
        frontier = [self.local_node_id]
        while frontier:
            nid = frontier.pop()
            if nid in self.quorum_map:
                continue
            q = lookup(nid)
            self.quorum_map[nid] = q
            if q is not None:
                for n in qset_nodes(q):
                    if n not in self.quorum_map:
                        frontier.append(n)

    def known_map(self) -> Dict[bytes, Optional[object]]:
        return dict(self.quorum_map)

    @property
    def node_count(self) -> int:
        return len(self.quorum_map)
