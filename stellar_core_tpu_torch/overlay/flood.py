"""Floodgate + pull-mode tx adverts.

Reference: src/overlay/Floodgate.{h,cpp} — per-message flood records keyed
by hash, remembering which peers already have it; clearBelow GC by ledger
seq.  src/overlay/TxAdverts.{h,cpp} — pull-mode tx flooding: hashes are
advertised (FLOOD_ADVERT), interested peers demand (FLOOD_DEMAND), only
then the full TRANSACTION flows.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from .. import xdr as X

ADVERT_FLUSH_BATCH = 50


class FloodRecord:
    __slots__ = ("ledger_seq", "peers_told")

    def __init__(self, ledger_seq: int):
        self.ledger_seq = ledger_seq
        # actual peer objects (NOT id()s: a freed peer's id can be reused
        # by a new allocation, silently aliasing flood state); records are
        # GC'd by clear_below so the references are bounded
        self.peers_told: Set[object] = set()


class Floodgate:
    def __init__(self) -> None:
        self._records: Dict[bytes, FloodRecord] = {}

    def add_record(self, msg_hash: bytes, ledger_seq: int,
                   from_peer=None) -> bool:
        """Record a message sighting; True when it is NEW (process it and
        re-flood), False when already seen (reference:
        Floodgate::addRecord).  The source peer is remembered either way so
        broadcast never echoes a message back."""
        rec = self._records.get(msg_hash)
        if rec is None:
            rec = self._records[msg_hash] = FloodRecord(ledger_seq)
            if from_peer is not None:
                rec.peers_told.add(from_peer)
            return True
        if from_peer is not None:
            rec.peers_told.add(from_peer)
        return False

    def seen(self, msg_hash: bytes) -> bool:
        return msg_hash in self._records

    def note_duplicate(self, msg_hash: bytes, from_peer) -> bool:
        """Record a repeat sighting WITHOUT needing the ledger seq: True
        when the hash is a known record (the peer is noted so broadcast
        never echoes back), False when the record is unknown/expired and
        the caller must take the full decode + add_record path."""
        rec = self._records.get(msg_hash)
        if rec is None:
            return False
        if from_peer is not None:
            rec.peers_told.add(from_peer)
        return True

    def note_told(self, msg_hash: bytes, peer) -> None:
        rec = self._records.get(msg_hash)
        if rec is not None:
            rec.peers_told.add(peer)

    def peers_told(self, msg_hash: bytes) -> Set[object]:
        rec = self._records.get(msg_hash)
        return rec.peers_told if rec is not None else set()

    def clear_below(self, ledger_seq: int) -> None:
        for h in [h for h, r in self._records.items()
                  if r.ledger_seq < ledger_seq]:
            del self._records[h]


class TxAdverts:
    """Per-peer advert/demand queues (pull-mode flooding)."""

    def __init__(self, send_advert: Callable, send_demand: Callable):
        self._send_advert = send_advert    # (peer, [hashes])
        self._send_demand = send_demand
        self._outgoing: Dict[int, List[bytes]] = {}   # id(peer) -> hashes
        self._peers: Dict[int, object] = {}

    def queue_advert(self, peer, tx_hash: bytes) -> None:
        pid = id(peer)
        self._peers[pid] = peer
        q = self._outgoing.setdefault(pid, [])
        q.append(tx_hash)
        if len(q) >= ADVERT_FLUSH_BATCH:
            self.flush_peer(peer)

    def flush_peer(self, peer) -> None:
        q = self._outgoing.pop(id(peer), None)
        self._peers.pop(id(peer), None)
        if q:
            self._send_advert(peer, q[:X.TX_ADVERT_VECTOR_MAX_SIZE])

    def flush_all(self) -> None:
        for pid in list(self._outgoing):
            peer = self._peers.get(pid)
            if peer is not None:
                self.flush_peer(peer)

    def forget_peer(self, peer) -> None:
        self._outgoing.pop(id(peer), None)
        self._peers.pop(id(peer), None)


class ItemFetcher:
    """Hash-addressed fetch of tx sets / quorum sets from peers.

    Reference: src/overlay/ItemFetcher.{h,cpp} + Tracker — one tracker per
    wanted hash, asking one peer at a time, advancing on DONT_HAVE or peer
    drop, re-asking as new peers authenticate, and RETRYING on a timer
    (reference: MS_TO_WAIT_FOR_FETCH_REPLY): a request or reply frame
    lost in flight (lossy link, peer severed mid-fetch) must not wedge
    the tracker until some unrelated peer happens to authenticate — the
    chaos link-degradation campaigns wedge exactly there without it.
    Once every current peer has been asked, a retry round clears the
    asked set and starts over; after RETRY_LIMIT rounds the tracker is
    dropped (the item is gone network-wide — e.g. a tx set purged past
    the peers' slot memory) so dead hashes don't re-arm timers forever."""

    RETRY_PERIOD_S = 1.5
    RETRY_LIMIT = 64

    def __init__(self, ask: Callable, clock=None,
                 peers_fn: Optional[Callable[[], List]] = None):
        self._ask = ask               # (peer, item_type, hash)
        self._clock = clock
        self._peers_fn = peers_fn
        self._tracking: Dict[bytes, dict] = {}

    def fetch(self, item_type: str, h: bytes, peers: List) -> None:
        if h in self._tracking:
            return
        self._tracking[h] = {"type": item_type, "asked": set(),
                             "retries": 0, "timer": None}
        self._try_next(h, peers)
        self._arm_retry(h)

    def _try_next(self, h: bytes, peers: List) -> None:
        tr = self._tracking.get(h)
        if tr is None:
            return
        for peer in peers:
            if peer not in tr["asked"]:
                tr["asked"].add(peer)
                self._ask(peer, tr["type"], h)
                return
        # nobody left to ask; the retry timer (or a new peer) re-opens

    def _arm_retry(self, h: bytes) -> None:
        if self._clock is None:
            return
        from ..util.clock import VirtualTimer
        tr = self._tracking.get(h)
        if tr is None:
            return
        timer = VirtualTimer(self._clock)
        tr["timer"] = timer
        timer.expires_from_now(self.RETRY_PERIOD_S,
                               lambda: self._retry(h))

    def _retry(self, h: bytes) -> None:
        tr = self._tracking.get(h)
        if tr is None:
            return   # answered (stop_fetch) since the timer was armed
        peers = self._peers_fn() if self._peers_fn is not None else []
        if all(p in tr["asked"] for p in peers):
            # full round exhausted (vacuously so when no peers exist):
            # count ROUNDS, not timer fires — with more peers than
            # RETRY_LIMIT every peer must still be asked once before the
            # tracker can be declared dead
            tr["retries"] += 1
            if tr["retries"] > self.RETRY_LIMIT:
                del self._tracking[h]
                return
            tr["asked"].clear()
        self._try_next(h, peers)
        self._arm_retry(h)

    def dont_have(self, h: bytes, from_peer, peers: List) -> None:
        self._try_next(h, peers)

    def peer_available(self, peer, peers: List) -> None:
        for h in list(self._tracking):
            self._try_next(h, peers)

    def stop_fetch(self, h: bytes) -> None:
        tr = self._tracking.pop(h, None)
        if tr is not None and tr.get("timer") is not None:
            tr["timer"].cancel()

    def wanted(self) -> List[bytes]:
        return list(self._tracking)
