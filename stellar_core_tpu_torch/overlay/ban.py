"""BanManager: persistent node-ID ban list.

Reference: src/overlay/BanManagerImpl.{h,cpp} — bans are by node identity
(not IP), stored in the ``ban`` DB table, enforced at authentication time
and consulted by `/bans` + `/unban` admin endpoints.
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..util import eventlog


class BanManager:
    def __init__(self, database=None):
        self.db = database
        self._banned: Set[bytes] = set()
        if database is not None:
            self._banned.update(database.load_bans())

    def ban_node(self, node_id: bytes) -> None:
        if node_id in self._banned:
            return
        self._banned.add(node_id)
        eventlog.record("Overlay", "WARNING", "node banned",
                        node=node_id.hex()[:16])
        if self.db is not None:
            self.db.store_ban(node_id)
            self.db.commit()

    def unban_node(self, node_id: bytes) -> None:
        if node_id in self._banned:
            eventlog.record("Overlay", "INFO", "node unbanned",
                            node=node_id.hex()[:16])
        self._banned.discard(node_id)
        if self.db is not None:
            self.db.delete_ban(node_id)
            self.db.commit()

    def is_banned(self, node_id: Optional[bytes]) -> bool:
        return node_id is not None and node_id in self._banned

    def banned_nodes(self) -> List[bytes]:
        return sorted(self._banned)
