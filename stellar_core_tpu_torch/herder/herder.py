"""Herder — drives SCP per ledger and glues consensus to the ledger.

Reference: src/herder/HerderImpl.{h,cpp} — recvSCPEnvelope, recvTransaction,
recvTxSet/recvSCPQuorumSet, triggerNextLedger, valueExternalized,
processSCPQueue, out-of-sync detection; src/herder/HerderSCPDriver.{h,cpp} —
the SCPDriver implementation (validateValue, combineCandidates,
signEnvelope/verifyEnvelope with the network-bound SCP envelope domain,
emitEnvelope, timers).  Merged into one class here: the driver half is the
SCPDriver overrides, the herder half is the public node API — the split in
the reference exists for header-dependency reasons this package doesn't
have.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

from .. import xdr as X
from ..crypto import keys
from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..scp.driver import SCPDriver, ValidationLevel
from ..scp.scp import SCP, EnvelopeState
from ..soroban import (decode_tx_set, tx_set_envelopes,
                       tx_set_previous_hash)
from ..util import detguard
from ..util import eventlog
from ..util import logging as slog
from ..util import tracing
from ..util.clock import VirtualClock, VirtualTimer
from ..util.metrics import registry as _registry
from .pending_envelopes import (ENVELOPE_STATUS_DISCARDED,
                                ENVELOPE_STATUS_FETCHING,
                                ENVELOPE_STATUS_PROCESSED,
                                ENVELOPE_STATUS_READY, PendingEnvelopes)
from .quorum_tracker import QuorumTracker
from .tx_queue import AddResult, TransactionQueue
from .upgrades import Upgrades

log = slog.get("Herder")

# Reference: src/herder/Herder.h
EXP_LEDGER_TIMESPAN_SECONDS = 5
MAX_SCP_TIMEOUT_SECONDS = 240
CONSENSUS_STUCK_TIMEOUT_SECONDS = 35
MAX_TIME_SLIP_SECONDS = 60
NODE_EXPIRATION_SECONDS = 240
LEDGER_VALIDITY_BRACKET = 100        # max slots ahead we accept
MAX_SLOTS_TO_REMEMBER = 12

ENVELOPE_TYPE_SCP = 1  # reference: Stellar-ledger-entries.x — EnvelopeType


class HerderState:
    # Reference: Herder::State
    BOOTING = "booting"
    SYNCING = "syncing"
    TRACKING = "tracking"


class Herder(SCPDriver):
    """One node's consensus engine.

    Wiring: `broadcast` is injected by the overlay (or the in-process
    simulation bus); `out_of_sync_handler` is the catchup handoff.
    """

    def __init__(self, clock: VirtualClock, ledger_manager,
                 secret: SecretKey, qset,
                 is_validator: bool = True,
                 upgrades: Optional[Upgrades] = None):
        self.clock = clock
        self.lm = ledger_manager
        self.secret = secret
        self.node_id = secret.public_key.ed25519
        self.network_id = ledger_manager.network_id
        self.is_validator = is_validator
        self.upgrades = upgrades or Upgrades()

        self.scp = SCP(self, self.node_id, is_validator, qset)
        self.pending = PendingEnvelopes()
        self.tx_queue = TransactionQueue(ledger_manager)
        # node -> last announced qset hash: quorum-tracker maintenance
        # runs only when a node actually CHANGES its quorum set, not once
        # per envelope (the expand walk re-encoded the qset per envelope
        # — measurably hot at 150+ simulated nodes)
        self._node_qset_hash: Dict[bytes, bytes] = {}
        # batched admission (herder/admission.py); None = legacy inline
        # single-sig intake.  Installed via enable_admission().
        self.admission = None
        self.quorum_tracker = QuorumTracker(self.node_id)
        self.pending.add_qset(qset)

        self.state = HerderState.BOOTING
        self.broadcast: Callable[[object], None] = lambda env: None
        self.tx_flood: Callable[[object], None] = lambda frame: None
        self.out_of_sync_handler: Callable[[], None] = lambda: None
        # observability hook (survey lostSyncCount); fires on each
        # tracking -> syncing transition
        self.lost_sync_hook: Callable[[], None] = lambda: None
        self.ledger_closed_hook: Callable[[object], None] = lambda arts: None

        self.db = None  # database.Database; attach_persistence()
        # reference: Config::ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING
        self.ledger_timespan = EXP_LEDGER_TIMESPAN_SECONDS
        self._timers: Dict[Tuple[int, int], VirtualTimer] = {}
        self._trigger_timer: Optional[VirtualTimer] = None
        self._tracking_timer: Optional[VirtualTimer] = None
        self._last_trigger_at: float = clock.now()
        # slot -> externalized StellarValue waiting for its ledger turn
        self._buffered: Dict[int, X.StellarValue] = {}
        self._processing_ready = False
        # slot -> perf_counter at nomination trigger (scp.slot.externalize
        # timer: nomination start -> value applied)
        self._nominate_started: Dict[int, float] = {}
        # last slot that got a tx-flood phase mark (one mark per slot)
        self._flood_marked_slot = 0
        # recovery bookkeeping: how often this node fell out of sync, how
        # many ledgers it applied from the buffered-externalize queue
        # while catching back up, and how often it had to resync from a
        # history archive — the chaos runner asserts a stalled validator
        # actually exercised these paths after rejoin instead of
        # inferring recovery from the LCL alone
        self.recovery_stats: Dict[str, int] = {"out_of_sync": 0,
                                               "buffered_applied": 0,
                                               "archive_catchups": 0}
        # fires every time the buffered-externalize queue dead-ends (the
        # next needed slot is older than any peer remembers) — the
        # archive-catchup handoff listens here.  Distinct from
        # out_of_sync_handler, which fires only on the TRACKING->SYNCING
        # edge: a node that is already syncing but discovers its gap
        # exceeds the fleet's slot memory must still reach the archive.
        self.sync_gap_hook: Callable[[], None] = lambda: None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def bootstrap(self) -> None:
        """Go live assuming the LCL is current (standalone/test networks).
        Reference: HerderImpl::bootstrap (FORCE_SCP path)."""
        self._set_state(HerderState.TRACKING, "bootstrap")
        self._last_trigger_at = self.clock.now()
        self._arm_tracking_heartbeat()
        self.trigger_next_ledger(self.tracking_consensus_ledger_index() + 1)

    def start(self) -> None:
        """Go live and wait for consensus traffic before participating.
        Reference: HerderImpl::start/restoreState."""
        self._set_state(HerderState.SYNCING, "start")

    def _set_state(self, state: str, why: str) -> None:
        """State transitions are SCP phase edges — flight-recorded so a
        post-mortem shows when (and why) the node entered/left tracking."""
        if state == self.state:
            return
        old, self.state = self.state, state
        eventlog.record("SCP", "INFO", "herder state transition",
                        old=old, new=state, why=why,
                        lcl=self.tracking_consensus_ledger_index())

    def tracking_consensus_ledger_index(self) -> int:
        return self.lm.last_closed_ledger_seq

    def next_ledger_index(self) -> int:
        return self.tracking_consensus_ledger_index() + 1

    # ------------------------------------------------------------------
    # intake (called by overlay / HTTP / simulation)
    # ------------------------------------------------------------------
    # SCP statement pledge type -> per-phase meter suffix (observability:
    # the nomination/ballot phase mix is how an operator sees where
    # consensus rounds spend their envelopes)
    _PHASE_METERS = {0: "scp.envelope.prepare", 1: "scp.envelope.confirm",
                     2: "scp.envelope.externalize",
                     3: "scp.envelope.nominate"}

    def recv_scp_envelope(self, env) -> str:
        st = env.statement
        slot = st.slotIndex
        lcl = self.tracking_consensus_ledger_index()
        if slot <= lcl - MAX_SLOTS_TO_REMEMBER or \
                slot > lcl + LEDGER_VALIDITY_BRACKET:
            # The silent dead-end of every stuck-node incident: a node
            # whose gap exceeds the slot-memory window throws its peers'
            # (stale-looking) envelopes away and stops externalizing with
            # no externally visible cause.  Meter + flight-record the
            # discard so /dumpflight answers "why did this node stop".
            self._note_envelope_discarded(
                slot, lcl,
                "below-memory-window" if slot <= lcl - MAX_SLOTS_TO_REMEMBER
                else "beyond-validity-bracket")
            return ENVELOPE_STATUS_DISCARDED
        if not self.verify_envelope(env):
            self._note_envelope_discarded(slot, lcl, "bad-signature")
            return ENVELOPE_STATUS_DISCARDED
        _registry().meter("scp.envelope.receive").mark()
        phase = self._PHASE_METERS.get(int(st.pledges.type))
        if phase is not None:
            _registry().meter(phase).mark()
        status = self.pending.recv_envelope(env)
        if status == ENVELOPE_STATUS_READY:
            self._process_scp_queue()
        return status

    def _note_envelope_discarded(self, slot: int, lcl: int,
                                 reason: str) -> None:
        _registry().meter("herder.scp.envelope-discarded").mark()
        eventlog.record("SCP", "WARNING", "scp envelope discarded",
                        slot=slot, lcl=lcl, reason=reason)

    def recv_tx_set(self, txset_hash: bytes, txset) -> bool:
        """Reference: HerderImpl::recvTxSet.  The hash gate runs FIRST so
        no frame-construction work (or exception) can be triggered by a tx
        set whose hash doesn't match what was requested."""
        try:
            if sha256(txset.to_xdr()) != txset_hash:
                return False
        except X.XdrError:
            return False  # unencodable peer tx set == hash mismatch
        try:
            frames = [self.lm.make_frame(e) for e in tx_set_envelopes(txset)]
        except Exception:
            # Hash-correct tx set we cannot build frames for: this is a bug
            # (or unsupported tx shape) worth surfacing, not a peer lying.
            log.exception("frame construction failed for tx set %s",
                          txset_hash.hex()[:16])
            return False
        self.pending.add_txset(txset_hash, txset, frames)
        self._process_scp_queue()
        return True

    def recv_qset(self, qset) -> bool:
        """Reference: HerderImpl::recvSCPQuorumSet."""
        ok = self.pending.add_qset(qset)
        if ok:
            self._process_scp_queue()
        return ok

    def trace_node(self) -> str:
        """Node attribution for phase marks: the fleet-provisioned
        process node id when configured, else this herder's short public
        key — in-process multi-node simulations share one process but
        must still split the merged trace into per-node rows."""
        return slog.node_id() or self.node_id.hex()[:8]

    def _mark_flood(self, slot: int) -> None:
        """First tx flooded toward `slot` gets a phase mark (one per
        slot, not per tx — floods are per-transaction hot)."""
        if self._flood_marked_slot != slot:
            self._flood_marked_slot = slot
            tracing.mark_phase("tx-flood", slot, node=self.trace_node())

    def recv_transaction(self, frame, origin: str = "api") -> AddResult:
        """Reference: HerderImpl::recvTransaction (from /tx or overlay).
        With an admission pipeline enabled, intake is batched: the frame
        joins the current admission batch (verified on the accel path when
        it wins the CPU race) and flooding happens once admitted.  Without
        one, the legacy single-sig path runs inline.  Newly-pending txs
        are flooded to peers either way."""
        if self.admission is not None:
            return self.admission.submit(frame, origin=origin)
        res = self.tx_queue.try_add(frame)
        if res.code == AddResult.STATUS_PENDING:
            self._mark_flood(self.lm.last_closed_ledger_seq + 1)
            self.tx_flood(frame)
        return res

    def enable_admission(self, accel: bool = False, **knobs) -> None:
        """Install the batched admission pipeline in front of the
        tx-queue (herder/admission.py).  Admitted frames flood exactly
        like the legacy path did."""
        from .admission import AdmissionPipeline

        def _flood(frame, origin):
            self._mark_flood(self.lm.last_closed_ledger_seq + 1)
            self.tx_flood(frame)

        self.admission = AdmissionPipeline(
            self.tx_queue, self.lm, self.clock, accel=accel,
            on_admitted=_flood, **knobs)

    def _process_scp_queue(self) -> None:
        if self._processing_ready:
            return
        self._processing_ready = True
        try:
            progressed = True
            while progressed:
                progressed = False
                for slot in self.pending.ready_slots():
                    for env in self.pending.pop_ready(slot):
                        self._track_qset(env.statement)
                        self.scp.receive_envelope(env)
                        progressed = True
        finally:
            self._processing_ready = False

    def _track_qset(self, st) -> None:
        from .pending_envelopes import statement_qset_hash
        qh = statement_qset_hash(st)
        nid = st.nodeID.value
        if self._node_qset_hash.get(nid) == qh:
            return   # same announced qset: the quorum map is unchanged
        q = self.pending.get_qset(qh)
        if q is not None:
            self._node_qset_hash[nid] = qh
            if not self.quorum_tracker.expand(nid, q):
                self.quorum_tracker.rebuild(self._qset_of_node)

    def _qset_of_node(self, node_id: bytes):
        if node_id == self.node_id:
            return self.scp.local_node.qset
        env = None
        for slot_idx in sorted(self.scp.slots, reverse=True):
            env = self.scp.slots[slot_idx].get_latest_message(node_id)
            if env is not None:
                break
        if env is None:
            return None
        from .pending_envelopes import statement_qset_hash
        return self.pending.get_qset(statement_qset_hash(env.statement))

    # ------------------------------------------------------------------
    # consensus drive
    # ------------------------------------------------------------------
    def trigger_next_ledger(self, seq: int) -> None:
        """Nominate a value for `seq`.  Reference:
        HerderImpl::triggerNextLedger."""
        if not self.is_validator or self.state != HerderState.TRACKING:
            return
        if seq != self.next_ledger_index():
            return
        self._last_trigger_at = self.clock.now()
        # clock time, not perf_counter: under a virtual clock the
        # consensus latency IS virtual (timeout-driven); wall time would
        # report crank speed instead
        self._nominate_started.setdefault(seq, self.clock.now())
        with detguard.region("nomination"):
            frames = self.tx_queue.tx_set_frames()
            tracing.mark_phase("nominate", seq, node=self.trace_node(),
                               txs=len(frames))
            tx_set, tx_set_hash, ordered = self.lm.make_tx_set_any(frames)
            self.pending.add_txset(tx_set_hash, tx_set, ordered)

            lcl = self.lm.lcl_header
            close_time = max(self.clock.system_now(),
                             lcl.scpValue.closeTime + 1)
            ups = self.upgrades.create_upgrades_for(lcl, close_time)
            sv = X.StellarValue(txSetHash=tx_set_hash, closeTime=close_time,
                                upgrades=ups)
            prev = lcl.scpValue.to_xdr()
            self.scp.nominate(seq, sv.to_xdr(), prev)

    # ------------------------------------------------------------------
    # SCPDriver: value semantics
    # ------------------------------------------------------------------
    def _decode_value(self, value: bytes) -> Optional[X.StellarValue]:
        try:
            return X.StellarValue.from_xdr(value)
        except X.XdrError:
            return None

    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> ValidationLevel:
        """Reference: HerderSCPDriver::validateValue/validateValueHelper."""
        sv = self._decode_value(value)
        if sv is None:
            return ValidationLevel.INVALID
        lcl = self.lm.lcl_header
        next_seq = self.next_ledger_index()
        if slot_index == next_seq:
            if sv.closeTime <= lcl.scpValue.closeTime:
                return ValidationLevel.INVALID
            if sv.closeTime > self.clock.system_now() + MAX_TIME_SLIP_SECONDS:
                return ValidationLevel.INVALID
        got = self.pending.get_txset(sv.txSetHash)
        if got is None:
            # can't fully check yet (tx set still fetching)
            return ValidationLevel.MAYBE_VALID
        txset, _frames = got
        if slot_index == next_seq \
                and tx_set_previous_hash(txset) != self.lm.lcl_hash:
            return ValidationLevel.INVALID
        for up in sv.upgrades:
            if not self.upgrades.is_valid(up, lcl, nomination=nomination,
                                          close_time=sv.closeTime):
                if nomination:
                    return ValidationLevel.INVALID
                # ballot: tolerate upgrades we don't want but others voted
                if not self.upgrades.is_valid(up, lcl, nomination=False):
                    return ValidationLevel.INVALID
        return ValidationLevel.FULLY_VALIDATED

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        """Strip invalid upgrades (reference:
        HerderSCPDriver::extractValidValue)."""
        sv = self._decode_value(value)
        if sv is None:
            return None
        lcl = self.lm.lcl_header
        kept = [u for u in sv.upgrades
                if self.upgrades.is_valid(u, lcl, nomination=True,
                                          close_time=sv.closeTime)]
        sv2 = X.StellarValue(txSetHash=sv.txSetHash, closeTime=sv.closeTime,
                             upgrades=kept)
        # Validate the STRIPPED value: its remaining upgrades are all wanted,
        # so this is the reference's validateValueHelper (which skips upgrade
        # checks) applied to the repaired value.  Validating the original
        # would return INVALID exactly when an unwanted upgrade is present —
        # the case this method exists to repair.  MAYBE_VALID (tx set evicted
        # from cache between processing steps) keeps the repaired value:
        # dropping it would stall nomination on the leader's value.
        if self.validate_value(slot_index, sv2.to_xdr(), True) == \
                ValidationLevel.INVALID:
            return None
        return sv2.to_xdr()

    def combine_candidates(self, slot_index: int,
                           candidates: List[bytes]) -> Optional[bytes]:
        """Reference: HerderSCPDriver::combineCandidates — highest
        closeTime; the tx set with most operations (hash tiebreak);
        upgrades merged per type taking the max parameter."""
        best_sv = None
        best_key = None
        max_ct = 0
        upgrades_by_type: Dict[int, bytes] = {}
        for cand in candidates:
            sv = self._decode_value(cand)
            if sv is None:
                continue
            max_ct = max(max_ct, sv.closeTime)
            got = self.pending.get_txset(sv.txSetHash)
            n_ops = 0
            if got is not None:
                _txset, frames = got
                n_ops = sum(f.num_operations() for f in frames)
            key = (n_ops, sv.txSetHash)
            if best_key is None or key > best_key:
                best_key, best_sv = key, sv
            for u in sv.upgrades:
                try:
                    up = X.LedgerUpgrade.from_xdr(u)
                except X.XdrError:
                    continue
                t = int(up.switch)
                cur = upgrades_by_type.get(t)
                if cur is None or X.LedgerUpgrade.from_xdr(cur).value < up.value:
                    upgrades_by_type[t] = u
        if best_sv is None:
            return None
        out = X.StellarValue(
            txSetHash=best_sv.txSetHash, closeTime=max_ct,
            upgrades=[upgrades_by_type[t]
                      for t in sorted(upgrades_by_type)])
        return out.to_xdr()

    # ------------------------------------------------------------------
    # SCPDriver: plumbing
    # ------------------------------------------------------------------
    def get_qset(self, qset_hash: bytes):
        if qset_hash == self.scp.local_node.qset_hash:
            return self.scp.local_node.qset
        return self.pending.get_qset(qset_hash)

    def emit_envelope(self, envelope) -> None:
        self.broadcast(envelope)

    def _envelope_payload(self, statement) -> bytes:
        # Reference: HerderSCPDriver::signEnvelope — sign over
        # (networkID, ENVELOPE_TYPE_SCP, statement)
        return (self.network_id + struct.pack(">i", ENVELOPE_TYPE_SCP)
                + statement.to_xdr())

    def sign_envelope(self, envelope) -> None:
        envelope.signature = self.secret.sign(
            self._envelope_payload(envelope.statement))

    def verify_envelope(self, envelope) -> bool:
        try:
            return keys.verify_sig(
                keys.PublicKey(envelope.statement.nodeID.value),
                envelope.signature,
                self._envelope_payload(envelope.statement))
        except ValueError:
            # malformed nodeID / unencodable statement (XdrError IS-A
            # ValueError): verification fails
            return False

    def setup_timer(self, slot_index: int, timer_id: int, timeout: float,
                    callback) -> None:
        key = (slot_index, timer_id)
        t = self._timers.pop(key, None)
        if t is not None:
            t.cancel()
        if callback is None:
            return
        t = VirtualTimer(self.clock)
        t.expires_from_now(timeout, callback)
        self._timers[key] = t

    # ------------------------------------------------------------------
    # externalization → ledger close
    # ------------------------------------------------------------------
    def value_externalized(self, slot_index: int, value: bytes) -> None:
        """Reference: HerderImpl::valueExternalized →
        LedgerManager::valueExternalized; out-of-order slots are buffered
        (CatchupManager::processLedger) and drained in sequence."""
        sv = self._decode_value(value)
        if sv is None:
            log.error("externalized undecodable value at slot %d", slot_index)
            return
        lcl = self.tracking_consensus_ledger_index()
        if slot_index <= lcl:
            return
        self._buffered[slot_index] = sv
        eventlog.record("SCP", "INFO", "slot externalized",
                        slot=slot_index, lcl=lcl)
        tracing.mark_phase("externalize", slot_index,
                           node=self.trace_node(), lcl=lcl)
        if slot_index == lcl + 1:
            self._set_state(HerderState.TRACKING, "externalized next slot")
        self._drain_buffered()

    def _drain_buffered(self) -> None:
        # Drop stale entries at or below the LCL (catchup may have advanced
        # past them); they would otherwise accumulate and suppress the
        # min(buffered) > lcl+1 out-of-sync check below.
        lcl = self.tracking_consensus_ledger_index()
        for s in [s for s in self._buffered if s <= lcl]:
            del self._buffered[s]
        applied = 0
        while True:
            nxt = self.tracking_consensus_ledger_index() + 1
            sv = self._buffered.pop(nxt, None)
            if sv is None:
                break
            got = self.pending.get_txset(sv.txSetHash)
            if got is None:
                # externalized a tx set we never fetched: must catch up
                self._buffered[nxt] = sv
                self._lost_sync()
                return
            txset, frames = got
            applied += 1
            if applied > 1:
                # second-and-later ledgers in one drain call were sitting
                # in the buffer while this node lagged: that's the
                # buffered-externalize catchup path, not live consensus
                self.recovery_stats["buffered_applied"] += 1
            arts = self.lm.close_ledger(frames, sv.closeTime, tx_set=txset,
                                        stellar_value=sv)
            self._set_state(HerderState.TRACKING, "externalized value applied")
            self._arm_tracking_heartbeat()
            _registry().meter("herder.ledger.externalize").mark()
            t0 = self._nominate_started.pop(nxt, None)
            if t0 is not None:
                # nomination trigger -> externalized value applied (the
                # consensus-round latency an operator tunes timers against)
                _registry().timer("scp.slot.externalize").update(
                    self.clock.now() - t0)
            self._persist_scp_state(nxt, sv, txset)
            self.ledger_closed_hook(arts)
            self.tx_queue.remove_applied(frames)
            self.tx_queue.shift()
            seq = self.lm.last_closed_ledger_seq
            self.scp.purge_slots(seq + 1 - MAX_SLOTS_TO_REMEMBER
                                 if seq + 1 > MAX_SLOTS_TO_REMEMBER else 0,
                                 keep=0)
            self.pending.erase_below(seq + 1 - MAX_SLOTS_TO_REMEMBER
                                     if seq + 1 > MAX_SLOTS_TO_REMEMBER else 0)
            for s in [s for s in self._nominate_started if s <= seq]:
                del self._nominate_started[s]
            self._arm_trigger(seq + 1)
        if self._buffered and min(self._buffered) > \
                self.tracking_consensus_ledger_index() + 1:
            self._lost_sync()
            self.sync_gap_hook()

    def _arm_tracking_heartbeat(self) -> None:
        """Reference: HerderImpl::trackingHeartBeat — while this node
        believes it is tracking consensus, an externalized value must
        arrive within CONSENSUS_STUCK_TIMEOUT_SECONDS.  One-shot: rearmed
        on every applied value, NOT on expiry, so an idle herder arms no
        perpetual timer.  Expiry while still TRACKING means the node is
        stuck (isolated validator, partitioned minority) and must declare
        itself out of sync so the recovery machinery — SCP-state pull
        from peers, archive catchup handoff — takes over instead of
        waiting forever for envelopes that cannot arrive."""
        if self._tracking_timer is not None:
            self._tracking_timer.cancel()
        self._tracking_timer = VirtualTimer(self.clock)
        self._tracking_timer.expires_from_now(
            CONSENSUS_STUCK_TIMEOUT_SECONDS, self._herder_stuck)

    def _herder_stuck(self) -> None:
        if self.state != HerderState.TRACKING:
            return
        log.warning("no ledger externalized for %ds at lcl=%d: "
                    "declaring out of sync",
                    CONSENSUS_STUCK_TIMEOUT_SECONDS,
                    self.tracking_consensus_ledger_index())
        self._lost_sync()

    def _lost_sync(self) -> None:
        if self.state != HerderState.SYNCING:
            log.warning("herder out of sync at lcl=%d buffered=%s",
                        self.tracking_consensus_ledger_index(),
                        sorted(self._buffered))
            self.recovery_stats["out_of_sync"] += 1
            self._set_state(HerderState.SYNCING, "lost sync")
            self.lost_sync_hook()
            self.out_of_sync_handler()

    def _arm_trigger(self, next_seq: int) -> None:
        """Arm the ledger trigger so consensus rounds pace at
        EXP_LEDGER_TIMESPAN_SECONDS.  Reference: HerderImpl::
        ledgerClosed → triggerNextLedger timer."""
        if not self.is_validator:
            return
        if self._trigger_timer is not None:
            self._trigger_timer.cancel()
        due = self._last_trigger_at + self.ledger_timespan
        delay = max(0.0, due - self.clock.now())  # corelint: disable=float-discipline -- local timer pacing; close time stays integer
        self._trigger_timer = VirtualTimer(self.clock)
        self._trigger_timer.expires_from_now(
            delay, lambda: self.trigger_next_ledger(next_seq))

    # ------------------------------------------------------------------
    # SCP state persistence (reference: HerderImpl::persistSCPState /
    # restoreSCPState via HerderPersistence + PersistentState)
    # ------------------------------------------------------------------
    def attach_persistence(self, db) -> None:
        self.db = db

    def _persist_scp_state(self, slot: int, sv, txset) -> None:
        """Durably record the externalized slot's SCP messages, referenced
        quorum sets and tx set, so a restarted node can re-serve its last
        consensus state to peers."""
        if self.db is None:
            return
        from ..database import PersistentState
        from .pending_envelopes import statement_qset_hash
        envs = self.scp.slots[slot].get_current_state() \
            if slot in self.scp.slots else []
        qsets = []
        seen = set()
        for env in envs:
            qh = statement_qset_hash(env.statement)
            if qh not in seen:
                seen.add(qh)
                qs = self.pending.get_qset(qh)
                if qs is not None:
                    qsets.append(qs)
        self.db.save_scp_history(slot, envs, qsets)
        self.db.save_txset(sv.txSetHash, slot, txset.to_xdr())
        self.db.set_state(PersistentState.LAST_SCP_DATA, str(slot))
        if slot > MAX_SLOTS_TO_REMEMBER:
            self.db.prune_scp(slot - MAX_SLOTS_TO_REMEMBER)
        self.db.commit()

    def restore_scp_state(self) -> None:
        """Reload the persisted slot's tx sets, quorum sets and envelopes
        after a restart.  Envelopes re-enter through the normal intake so
        SCP slot state is rebuilt exactly as if received from peers."""
        if self.db is None:
            return
        from ..database import PersistentState
        val = self.db.get_state(PersistentState.LAST_SCP_DATA)
        if val is None:
            return
        for h, blob in self.db.load_txsets():
            try:
                txset = decode_tx_set(blob)
                frames = [self.lm.make_frame(e)
                          for e in tx_set_envelopes(txset)]
            except Exception:
                log.warning("dropping undecodable stored txset %s", h.hex())
                continue
            self.pending.add_txset(h, txset, frames)
        for qs in self.db.load_scp_quorums():
            self.pending.add_qset(qs)
        for env in self.db.load_scp_history(int(val)):
            self.recv_scp_envelope(env)
        log.info("restored SCP state for slot %s", val)

    # ------------------------------------------------------------------
    # SCP state sync (peer (re)connect / out-of-sync recovery)
    # ------------------------------------------------------------------
    def get_scp_state(self, from_seq: int) -> List:
        """Latest envelopes for every remembered slot >= from_seq, for
        bringing a lagging peer up to date.  Reference:
        HerderImpl::getSCPState / sendSCPStateToPeer (on peer auth) and
        getMoreSCPState (out-of-sync node pulling)."""
        out: List = []
        for idx in sorted(self.scp.slots):
            if idx >= from_seq:
                out.extend(self.scp.slots[idx].get_current_state())
        return out

    # ------------------------------------------------------------------
    # introspection (CLI/HTTP)
    # ------------------------------------------------------------------
    def get_state_human(self) -> str:
        return self.state

    def quorum_map(self) -> Dict[bytes, Optional[object]]:
        m = {}
        for nid in self.quorum_tracker.known_map():
            m[nid] = self._qset_of_node(nid)
        return m
