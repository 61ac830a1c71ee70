"""PeerManager: the address book + outbound connection policy.

Reference: src/overlay/PeerManager.{h,cpp} (peer records with numFailures /
nextAttempt backoff, persisted in the peers table), RandomPeerSource, and
OverlayManagerImpl::triggerPeerResolution / connectToMorePeers.

Addresses arrive from config (KNOWN_PEERS), from PEERS gossip, and from
the database on restart; the manager hands the application dial candidates
until the target outbound count is met, backing off failed addresses
exponentially.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from .. import xdr as X
from ..util import logging as slog

log = slog.get("Overlay")

MAX_FAILURES_TO_FORGET = 10      # reference: REALLY_DEAD_NUM_FAILURES_CUTOFF
BACKOFF_BASE_SECONDS = 10.0
MAX_PEERS_TO_SEND = 50


class PeerRecord:
    __slots__ = ("host", "port", "num_failures", "next_attempt")

    def __init__(self, host: str, port: int, num_failures: int = 0,
                 next_attempt: float = 0.0):
        self.host = host
        self.port = port
        self.num_failures = num_failures
        self.next_attempt = next_attempt

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)


class PeerManager:
    def __init__(self, clock, database=None,
                 rng: Optional[random.Random] = None,
                 self_port: int = 0):
        self.clock = clock
        self.db = database
        self._rng = rng or random.Random()
        self.self_port = self_port   # filter our own gossiped address
        self._records: Dict[Tuple[str, int], PeerRecord] = {}
        if database is not None:
            for host, port, failures in database.load_peers():
                self._records[(host, port)] = PeerRecord(host, port, failures)

    # -- intake -------------------------------------------------------------
    def _is_self(self, host: str, port: int) -> bool:
        return (self.self_port and port == self.self_port
                and host in ("127.0.0.1", "localhost", "::1"))

    def add_address(self, host: str, port: int) -> None:
        key = (host, int(port))
        if self._is_self(*key) or key in self._records:
            return
        self._records[key] = PeerRecord(host, int(port))
        self._persist(self._records[key])
        self._commit()

    def add_peer_addresses(self, peers) -> None:
        """PEERS message intake (reference: PeerManager::storePeerList);
        one DB commit for the whole batch."""
        for pa in peers:
            if pa.ip.switch != X.IPAddrType.IPv4:
                continue
            host = ".".join(str(b) for b in pa.ip.value)
            key = (host, int(pa.port))
            if not 0 < pa.port <= 65535 or self._is_self(*key) \
                    or key in self._records:
                continue
            self._records[key] = PeerRecord(*key)
            self._persist(self._records[key])
        self._commit()

    # -- outcomes -----------------------------------------------------------
    def record_success(self, host: str, port: int) -> None:
        rec = self._records.get((host, port))
        if rec is not None:
            rec.num_failures = 0
            rec.next_attempt = 0.0
            self._persist(rec)
            self._commit()

    def record_failure(self, host: str, port: int) -> None:
        rec = self._records.get((host, port))
        if rec is None:
            return
        rec.num_failures += 1
        if rec.num_failures > MAX_FAILURES_TO_FORGET:
            del self._records[(host, port)]
            if self.db is not None:
                self.db.delete_peer(host, port)
                self._commit()
            return
        backoff = BACKOFF_BASE_SECONDS * (2 ** min(rec.num_failures, 6))
        rec.next_attempt = self.clock.now() + backoff
        self._persist(rec)
        self._commit()

    def _persist(self, rec: PeerRecord) -> None:
        if self.db is not None:
            self.db.store_peer(rec.host, rec.port, rec.num_failures)

    def _commit(self) -> None:
        if self.db is not None:
            self.db.commit()

    # -- dialing ------------------------------------------------------------
    def dial_candidates(self, n: int, exclude=()) -> List[Tuple[str, int]]:
        """Up to n addresses ready for an attempt (reference:
        RandomPeerSource::getRandomPeers with backoff filtering)."""
        now = self.clock.now()
        ready = [r.addr for r in self._records.values()
                 if r.next_attempt <= now and r.addr not in set(exclude)]
        self._rng.shuffle(ready)
        return ready[:n]

    def peers_to_send(self) -> List[X.PeerAddress]:
        """Share the best-known addresses (reference:
        PeerManager::getPeersToSend — low-failure peers first)."""
        recs = sorted(self._records.values(), key=lambda r: r.num_failures)
        out = []
        for r in recs[:MAX_PEERS_TO_SEND]:
            try:
                octets = bytes(int(x) for x in r.host.split("."))
            except ValueError:
                continue
            if len(octets) != 4:
                continue
            out.append(X.PeerAddress(
                ip=X.PeerAddressIp.ipv4(octets), port=r.port,
                numFailures=r.num_failures))
        return out

    @property
    def size(self) -> int:
        return len(self._records)
