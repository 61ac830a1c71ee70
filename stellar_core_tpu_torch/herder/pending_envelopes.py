"""PendingEnvelopes — SCP envelope intake: hold envelopes until their
referenced quorum sets and tx sets are available, fetching missing items.

Reference: src/herder/PendingEnvelopes.{h,cpp} — recvSCPEnvelope,
recvSCPQuorumSet, recvTxSet, envelope state machine (FETCHING/READY/
PROCESSED), caches; src/overlay/ItemFetcher.h — hash-addressed fetch
(the fetch transport is a callback here; overlay wires it to peers).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .. import xdr as X
from ..crypto.sha import sha256
from ..scp.quorum import is_qset_sane, qset_hash
from ..util import logging as slog
from ..util.cache import RandomEvictionCache

log = slog.get("Herder")

# envelope intake verdicts (reference: Herder::EnvelopeStatus)
ENVELOPE_STATUS_DISCARDED = "discarded"
ENVELOPE_STATUS_FETCHING = "fetching"
ENVELOPE_STATUS_READY = "ready"
ENVELOPE_STATUS_PROCESSED = "processed"

QSET_CACHE_SIZE = 10000
TXSET_CACHE_SIZE = 10000


# one source of truth for the pledge-type -> quorumSetHash mapping
# (scp/quorum.py); re-exported here because every herder-layer consumer
# historically imports it from this module
from ..scp.quorum import statement_qset_hash  # noqa: E402,F401


def statement_values(st) -> List[bytes]:
    """All StellarValue blobs referenced by a statement.
    Reference: Slot::getStatementValues."""
    from ..xdr import scp as SX
    pl = st.pledges
    t = pl.type
    if t == SX.SCPStatementType.SCP_ST_NOMINATE:
        return list(pl.nominate.votes) + list(pl.nominate.accepted)
    if t == SX.SCPStatementType.SCP_ST_PREPARE:
        out = [pl.prepare.ballot.value]
        if pl.prepare.prepared is not None:
            out.append(pl.prepare.prepared.value)
        if pl.prepare.preparedPrime is not None:
            out.append(pl.prepare.preparedPrime.value)
        return out
    if t == SX.SCPStatementType.SCP_ST_CONFIRM:
        return [pl.confirm.ballot.value]
    return [pl.externalize.commit.value]


def statement_txset_hashes(st) -> List[bytes]:
    """Tx set hashes referenced by a statement's StellarValues (malformed
    values are reported by validation later, not here)."""
    out = []
    for v in statement_values(st):
        try:
            sv = X.StellarValue.from_xdr(v)
            out.append(sv.txSetHash)
        except X.XdrError:
            pass
    return out


class PendingEnvelopes:
    def __init__(self,
                 fetch_qset: Optional[Callable[[bytes], None]] = None,
                 fetch_txset: Optional[Callable[[bytes], None]] = None):
        # hash -> SCPQuorumSet / (TransactionSet, frames)
        self.qsets = RandomEvictionCache(QSET_CACHE_SIZE)
        self.txsets = RandomEvictionCache(TXSET_CACHE_SIZE)
        self.fetch_qset = fetch_qset or (lambda h: None)
        self.fetch_txset = fetch_txset or (lambda h: None)
        # slot -> list of (env, missing_qset_hashes, missing_txset_hashes)
        self.fetching: Dict[int, List] = {}
        self.ready: Dict[int, List] = {}
        # env xdr hash -> slot, for envelopes already handed to SCP
        # (GC'd with the slot in erase_below)
        self.processed_index: Dict[bytes, int] = {}
        # env xdr hash -> ENVELOPE_STATUS_{FETCHING,READY} for envelopes
        # currently queued (dedups re-received floods before processing)
        self.queued_index: Dict[bytes, str] = {}

    # -- item intake ------------------------------------------------------
    def add_qset(self, qset) -> bool:
        """Reference: PendingEnvelopes::recvSCPQuorumSet (+ sanity gate)."""
        if not is_qset_sane(qset):
            return False
        self.qsets.put(qset_hash(qset), qset)
        self._recheck()
        return True

    def add_txset(self, txset_hash: bytes, txset, frames) -> None:
        """Reference: PendingEnvelopes::recvTxSet."""
        self.txsets.put(txset_hash, (txset, frames))
        self._recheck()

    def get_qset(self, h: bytes):
        return self.qsets.get(h)

    def get_txset(self, h: bytes):
        got = self.txsets.get(h)
        return got if got is not None else None

    # -- envelope intake --------------------------------------------------
    def recv_envelope(self, env) -> str:
        """Returns an ENVELOPE_STATUS_*.  READY envelopes are queued in
        self.ready[slot] for the herder to pop."""
        slot = env.statement.slotIndex
        env_hash = sha256(env.to_xdr())
        if env_hash in self.processed_index:
            # Re-received (flooded or re-requested) envelope already handed
            # to SCP: discard without re-queuing (reference envelope state
            # machine returns PROCESSED for these).
            return ENVELOPE_STATUS_PROCESSED
        queued = self.queued_index.get(env_hash)
        if queued is not None:
            # Duplicate still in flight: report its current state without
            # re-queuing.  A FETCHING duplicate re-issues fetches for the
            # still-missing items — re-floods are the retry path for fetches
            # that found no peer with the item the first time.
            if queued == ENVELOPE_STATUS_FETCHING:
                mq, mt = self._missing(env.statement)
                for h in mq:
                    self.fetch_qset(h)
                for h in mt:
                    self.fetch_txset(h)
                self._recheck()
            return queued
        missing_q, missing_t = self._missing(env.statement)
        if not missing_q and not missing_t:
            self.ready.setdefault(slot, []).append((env, env_hash))
            self.queued_index[env_hash] = ENVELOPE_STATUS_READY
            return ENVELOPE_STATUS_READY
        for h in missing_q:
            self.fetch_qset(h)
        for h in missing_t:
            self.fetch_txset(h)
        self.fetching.setdefault(slot, []).append((env, env_hash))
        self.queued_index[env_hash] = ENVELOPE_STATUS_FETCHING
        return ENVELOPE_STATUS_FETCHING

    def _missing(self, st) -> Tuple[List[bytes], List[bytes]]:
        missing_q = []
        qh = statement_qset_hash(st)
        if self.qsets.get(qh) is None:
            missing_q.append(qh)
        missing_t = [h for h in statement_txset_hashes(st)
                     if self.txsets.get(h) is None]
        return missing_q, missing_t

    def _recheck(self) -> None:
        for slot in list(self.fetching):
            still = []
            for env, env_hash in self.fetching[slot]:
                mq, mt = self._missing(env.statement)
                if not mq and not mt:
                    self.ready.setdefault(slot, []).append((env, env_hash))
                    self.queued_index[env_hash] = ENVELOPE_STATUS_READY
                else:
                    still.append((env, env_hash))
            if still:
                self.fetching[slot] = still
            else:
                del self.fetching[slot]

    def pop_ready(self, slot: int) -> List:
        out = []
        for env, env_hash in self.ready.pop(slot, []):
            self.processed_index[env_hash] = slot
            self.queued_index.pop(env_hash, None)
            out.append(env)
        return out

    def has_ready(self) -> bool:
        return any(self.ready.values())

    def ready_slots(self) -> List[int]:
        return sorted(self.ready)

    # -- slot GC ----------------------------------------------------------
    def erase_below(self, slot: int) -> None:
        """Reference: PendingEnvelopes::eraseBelow (keep caches; drop
        per-slot pending envelopes)."""
        for d in (self.fetching, self.ready):
            for s in [s for s in d if s < slot]:
                for _env, env_hash in d[s]:
                    self.queued_index.pop(env_hash, None)
                del d[s]
        for h in [h for h, s in self.processed_index.items() if s < slot]:  # corelint: disable=iteration-order -- collects keys for keyed deletion; order-free
            del self.processed_index[h]
