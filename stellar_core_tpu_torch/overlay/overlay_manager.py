"""OverlayManager: peer lifecycle + flooding + herder integration.

Reference: src/overlay/OverlayManagerImpl.{h,cpp} — peer registry with
pending/authenticated split, broadcastMessage through the Floodgate,
recvFloodedMsg dedup, tx advert queues, item fetch wiring into the herder
(PendingEnvelopes), GET_SCP_STATE serving, connectTo/acceptAuthenticated.

Transport-agnostic: peers are Peer subclasses (LoopbackPeer for
deterministic tests, TCPPeer for real sockets — tcp.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .. import xdr as X
from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..util import eventlog
from ..util import logging as slog
from ..util.metrics import registry as _registry
from ..util.racetrace import race_checked
from .ban import BanManager
from .flood import Floodgate, ItemFetcher, TxAdverts
from .peer import Peer
from .peer_auth import PeerAuth
from .peer_manager import PeerManager
from .survey import SurveyManager

log = slog.get("Overlay")

# per-type intake meter names, precomputed: _message_received is the
# hottest overlay path and must not rebuild the slug per message
_RECV_METER = {t: "overlay.recv." + t.name.lower().replace("_", "-")
               for t in X.MessageType}


@race_checked
class OverlayManager:
    def __init__(self, clock, herder, network_id: bytes,
                 node_secret: SecretKey, listening_port: int = 0,
                 auth_seed: Optional[bytes] = None, database=None,
                 batching: bool = True, batch_max_messages: int = 64,
                 batch_max_bytes: int = 128 * 1024):
        self.clock = clock
        self.herder = herder
        self.network_id = network_id
        # batched authenticated transport (overlay/peer.py): willingness
        # to negotiate AUTH_FLAG_BATCH on every link this manager owns,
        # plus the per-peer coalescing-run caps.  Config surface:
        # OVERLAY_BATCHING / OVERLAY_BATCH_MAX_MESSAGES /
        # OVERLAY_BATCH_MAX_BYTES.
        self.batching = batching
        self.batch_max_messages = max(
            1, min(batch_max_messages, X.BATCH_WIRE_MAX_MESSAGES))
        self.batch_max_bytes = max(1, batch_max_bytes)
        self.node_id = node_secret.public_key.ed25519
        self.listening_port = listening_port
        self.peer_auth = PeerAuth(node_secret, network_id,
                                  now_fn=clock.system_now,
                                  auth_seed=auth_seed)
        self.pending_peers: List[Peer] = []
        # peer_id -> Peer; /peers snapshots this from admin threads
        self.authenticated_peers: Dict[bytes, Peer] = {}  # corelint: owned-by=main -- peer lifecycle runs on the crank loop; admin /peers reads are GIL-atomic snapshots
        self.peer_manager = PeerManager(clock, database,
                                        self_port=listening_port)
        self.floodgate = Floodgate()
        self.adverts = TxAdverts(self._send_advert, self._send_demand)
        self.fetcher = ItemFetcher(self._ask_for_item, clock=clock,
                                   peers_fn=self._auth_peer_list)
        self.ban_manager = BanManager(database)
        self.survey = SurveyManager(self, node_secret)
        herder.lost_sync_hook = self.survey.record_lost_sync
        self.stats = {"flooded": 0, "deduped": 0, "dropped_peers": 0,
              "txsets_served": 0, "qsets_served": 0}
        self._recv_meters: Dict[object, object] = {}
        # weak_gauge: must not pin a torn-down node's peer graph in the
        # process-global registry (dead source -> null gauge)
        _registry().weak_gauge("overlay.peer.authenticated", self,
                               lambda o: len(o.authenticated_peers))

        # herder wiring (same seams the in-process simulation uses)
        herder.broadcast = self.broadcast_scp_envelope
        herder.tx_flood = self.flood_transaction
        herder.pending.fetch_qset = lambda h: self.fetcher.fetch(
            "qset", h, self._auth_peer_list())
        herder.pending.fetch_txset = lambda h: self.fetcher.fetch(
            "txset", h, self._auth_peer_list())
        self._advert_timer = None
        self._start_advert_timer()

    ADVERT_FLUSH_INTERVAL = 0.5

    def _start_advert_timer(self) -> None:
        """Partially-filled advert batches flush on a cadence (reference:
        TxAdverts::startAdvertTimer ~100ms)."""
        from ..util.clock import VirtualTimer
        self._advert_timer = VirtualTimer(self.clock)

        def tick() -> None:
            self.adverts.flush_all()
            self._advert_timer.expires_from_now(
                self.ADVERT_FLUSH_INTERVAL, tick)

        self._advert_timer.expires_from_now(self.ADVERT_FLUSH_INTERVAL, tick)

    # -- peer registry ------------------------------------------------------
    def _register_peer(self, peer: Peer) -> None:
        self.pending_peers.append(peer)

    def _peer_authenticated(self, peer: Peer) -> None:
        if self.ban_manager.is_banned(peer.peer_id):
            peer.drop("banned node")
            return
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
        self.survey.record_added_peer()
        old = self.authenticated_peers.get(peer.peer_id)
        if old is not None and old is not peer:
            # simultaneous cross-connections: both sides must pick the SAME
            # survivor or each drops the other's keeper and the pair
            # disconnects entirely.  Symmetric rule: keep the connection
            # dialed by the lexicographically smaller node id.
            keep_new = peer.we_called_remote == (self.node_id < peer.peer_id)
            if not keep_new:
                peer.drop("duplicate connection (kept existing)")
                return
            old.drop("superseded by new connection")
        self.authenticated_peers[peer.peer_id] = peer
        log.info("peer %s authenticated (%s)", peer.peer_id.hex()[:8],
                 "outbound" if peer.we_called_remote else "inbound")
        eventlog.record("Overlay", "INFO", "peer authenticated",
                        peer=peer.peer_id.hex()[:8],
                        direction="outbound" if peer.we_called_remote
                        else "inbound",
                        authenticated=len(self.authenticated_peers))
        # learn the network (reference: Peer::recvAuth -> sendGetPeers)
        peer.send_message(X.StellarMessage.getPeers())
        if peer.remote_listening_port > 0 and hasattr(peer, "sock") \
                and peer.sock is not None:
            try:
                host = peer.sock.getpeername()[0]
                self.peer_manager.add_address(host,
                                              peer.remote_listening_port)
                self.peer_manager.record_success(host,
                                                 peer.remote_listening_port)
            except OSError:
                pass
        # bring the peer up to date on consensus (reference:
        # Peer::recvAuth -> sendSCPState... via Herder)
        for env in self.herder.get_scp_state(0):
            peer.send_message(X.StellarMessage.envelope(env))
        self.fetcher.peer_available(peer, self._auth_peer_list())

    def _peer_dropped(self, peer: Peer) -> None:
        _registry().counter("overlay.peer.drop").inc()
        self.stats["dropped_peers"] += 1
        eventlog.record("Overlay", "INFO", "peer dropped",
                        peer=peer.peer_id.hex()[:8]
                        if peer.peer_id else "(unauthenticated)",
                        reason=getattr(peer, "drop_reason", None) or "?")
        if peer.is_authenticated():
            self.survey.record_dropped_peer()
        # outbound dials that never authenticated feed the backoff policy
        dial = getattr(peer, "dial_addr", None)
        if dial is not None and peer.we_called_remote \
                and peer.state != Peer.GOT_AUTH and peer.peer_id is None:
            self.peer_manager.record_failure(*dial)
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
        if peer.peer_id is not None and \
                self.authenticated_peers.get(peer.peer_id) is peer:
            del self.authenticated_peers[peer.peer_id]
        self.adverts.forget_peer(peer)

    def _auth_peer_list(self) -> List[Peer]:
        return list(self.authenticated_peers.values())

    def num_authenticated(self) -> int:
        return len(self.authenticated_peers)

    def connected_addresses(self) -> set:
        """(host, listening_port) of live connections — the dial-exclusion
        set (pending dials included so a slow handshake isn't re-dialed)."""
        out = set()
        for peer in (*self.authenticated_peers.values(),
                     *self.pending_peers):
            dial = getattr(peer, "dial_addr", None)
            if dial is not None:
                out.add(dial)
            elif peer.peer_id is not None and peer.remote_listening_port \
                    and hasattr(peer, "sock") and peer.sock is not None:
                try:
                    out.add((peer.sock.getpeername()[0],
                             peer.remote_listening_port))
                except OSError:
                    pass
        return out

    # -- outbound flooding --------------------------------------------------
    def broadcast_scp_envelope(self, env) -> None:
        msg = X.StellarMessage.envelope(env)
        body = msg.to_xdr()
        h = sha256(body)
        self.floodgate.add_record(h, env.statement.slotIndex)
        self._broadcast(msg, h, body)

    def flood_transaction(self, frame) -> None:
        """Pull-mode: advertise the hash; peers demand what they miss."""
        h = frame.content_hash()
        self.floodgate.add_record(
            h, self.herder.tracking_consensus_ledger_index())
        for peer in self._auth_peer_list():
            if peer not in self.floodgate.peers_told(h):
                self.adverts.queue_advert(peer, h)

    def _broadcast(self, msg: X.StellarMessage, msg_hash: bytes,
                   body: Optional[bytes] = None) -> None:
        # `body` = the message's XDR encoding when the caller already has
        # it: a fleet-wide flood re-encoding the identical payload once
        # per peer was measurably hot at 150+ simulated nodes
        told = self.floodgate.peers_told(msg_hash)
        flood_meter = _registry().meter("overlay.message.flood")
        for peer in self._auth_peer_list():
            if peer not in told:
                peer.send_message(msg, body=body)
                self.floodgate.note_told(msg_hash, peer)
                self.stats["flooded"] += 1
                flood_meter.mark()

    def _send_advert(self, peer: Peer, hashes: List[bytes]) -> None:
        peer.send_message(X.StellarMessage.floodAdvert(
            X.FloodAdvert(txHashes=hashes)))

    def _send_demand(self, peer: Peer, hashes: List[bytes]) -> None:
        peer.send_message(X.StellarMessage.floodDemand(
            X.FloodDemand(txHashes=hashes)))

    def _ask_for_item(self, peer: Peer, item_type: str, h: bytes) -> None:
        if item_type == "txset":
            peer.send_message(X.StellarMessage.txSetHash(h))
        else:
            peer.send_message(X.StellarMessage.qSetHash(h))

    def request_scp_state(self) -> None:
        """Ask every authenticated peer for recent SCP state (reference:
        HerderImpl::getMoreSCPState → Peer::sendGetScpState) — the lagging
        node's first recovery step; archive catchup takes over when the
        gap exceeds the peers' slot memory."""
        seq = max(0, self.herder.tracking_consensus_ledger_index() - 1)
        for peer in self._auth_peer_list():
            peer.send_message(X.StellarMessage.getSCPLedgerSeq(seq))

    def flush_adverts(self) -> None:
        self.adverts.flush_all()

    # -- admission back-pressure (reference: FlowControl's capacity model
    #    is the valve; the admission queue depth is the signal) ------------
    def flood_grants_paused(self) -> bool:
        """True while the herder's admission pipeline is back-pressured:
        peers' earned flow-control capacity is deferred, throttling the
        flood intake feeding the backlog (overlay/peer.py)."""
        adm = getattr(self.herder, "admission", None)
        return adm is not None and adm.backpressured

    def release_flood_grants(self) -> None:
        """Back-pressure released: ship every deferred grant (wired to
        AdmissionPipeline.on_backpressure_release)."""
        for peer in self._auth_peer_list():
            peer.release_deferred_grant()

    def clear_below(self, ledger_seq: int) -> None:
        self.floodgate.clear_below(ledger_seq)
        self.survey.maybe_expire()

    # -- inbound dispatch ---------------------------------------------------
    def ledger_version(self) -> int:
        return self.herder.lm.lcl_header.ledgerVersion

    def _message_received(self, peer: Peer, msg: X.StellarMessage,
                          body: Optional[bytes] = None,
                          body_hash: Optional[bytes] = None) -> None:
        # `body` = the message's own XDR bytes as received (sliced from
        # the authenticated frame) — the SCP hot path hashes and
        # re-floods them without a re-encode
        t = msg.switch
        MT = X.MessageType
        # per-message-type intake meter (reference: the per-type
        # "overlay.recv.*" medida timers in Peer::recvMessage); meter
        # objects cached per manager — a registry lookup per message is
        # real money at simulated-fleet message rates
        meter = self._recv_meters.get(t)
        if meter is None:
            meter = self._recv_meters[t] = _registry().meter(_RECV_METER[t])
        meter.mark()
        if t in (MT.SEND_MORE, MT.SEND_MORE_EXTENDED):
            return  # handled in Peer flow control
        if t == MT.SCP_MESSAGE:
            self._recv_scp(peer, msg, body, body_hash)
        elif t == MT.TRANSACTION:
            self._recv_transaction(peer, msg)
        elif t == MT.FLOOD_ADVERT:
            self._recv_advert(peer, msg.value.txHashes)
        elif t == MT.FLOOD_DEMAND:
            self._recv_demand(peer, msg.value.txHashes)
        elif t == MT.GET_TX_SET:
            self._serve_txset(peer, msg.value)
        elif t in (MT.TX_SET, MT.GENERALIZED_TX_SET):
            txset = msg.value
            h = sha256(txset.to_xdr())
            self.fetcher.stop_fetch(h)
            self.herder.recv_tx_set(h, txset)
        elif t == MT.DONT_HAVE:
            self.fetcher.dont_have(msg.value.reqHash, peer,
                                   self._auth_peer_list())
        elif t == MT.GET_SCP_QUORUMSET:
            self._serve_qset(peer, msg.value)
        elif t == MT.SCP_QUORUMSET:
            qs = msg.value
            from ..scp.quorum import qset_hash
            self.fetcher.stop_fetch(qset_hash(qs))
            self.herder.recv_qset(qs)
        elif t == MT.GET_SCP_STATE:
            for env in self.herder.get_scp_state(msg.value):
                peer.send_message(X.StellarMessage.envelope(env))
        elif t == MT.GET_PEERS:
            peer.send_message(X.StellarMessage.peers(
                self.peer_manager.peers_to_send()))
        elif t == MT.PEERS:
            self.peer_manager.add_peer_addresses(msg.value)
        elif t in (MT.TIME_SLICED_SURVEY_REQUEST,
                   MT.TIME_SLICED_SURVEY_RESPONSE,
                   MT.TIME_SLICED_SURVEY_START_COLLECTING,
                   MT.TIME_SLICED_SURVEY_STOP_COLLECTING):
            self._recv_survey(peer, msg)
        else:
            log.warning("unhandled message type %s", t)

    def _recv_survey(self, peer: Peer, msg: X.StellarMessage) -> None:
        """Dedup + dispatch to the SurveyManager; relay when the handler
        accepts the message (reference: Peer::recvSurvey* →
        SurveyManager::relayOrProcess...)."""
        h = sha256(msg.to_xdr())
        if not self.floodgate.add_record(
                h, self.herder.tracking_consensus_ledger_index(), peer):
            self.stats["deduped"] += 1
            _registry().meter("overlay.flood.duplicate").mark()
            return
        t = msg.switch
        MT = X.MessageType
        handler = {
            MT.TIME_SLICED_SURVEY_REQUEST: self.survey.recv_request,
            MT.TIME_SLICED_SURVEY_RESPONSE: self.survey.recv_response,
            MT.TIME_SLICED_SURVEY_START_COLLECTING:
                self.survey.recv_start_collecting,
            MT.TIME_SLICED_SURVEY_STOP_COLLECTING:
                self.survey.recv_stop_collecting,
        }[t]
        if handler(peer, msg.value):
            self._broadcast(msg, h)

    # -- transport-level duplicate fast path --------------------------------
    # The batched receive path slices raw bodies before decoding them;
    # for SCP traffic (dedup-keyed on sha256 of the body bytes) that seam
    # lets a flood duplicate be recognised and dropped BEFORE paying the
    # XDR decode — at fleet scale most deliveries are duplicates, so this
    # is where the soak's receive-side codec time goes.
    def flood_seen(self, body_hash: bytes) -> bool:
        """Pure check (no mutation): is this body hash a known flood
        record?  Peer uses it during batch validation, where nothing may
        change observable state until the whole frame proves well-formed."""
        return self.floodgate.seen(body_hash)

    def _note_flood_duplicate(self, peer: Peer, body_hash: bytes) -> bool:
        """Account a pre-decode duplicate drop: notes the sender on the
        flood record (broadcast must not echo back) and marks the same
        dedup stats the decoded path would.  False when the record was
        GC'd between the frame's validation and dispatch phases (a ledger
        close mid-run ran clear_below) — the caller falls back to the
        full decode + dispatch path."""
        if not self.floodgate.note_duplicate(body_hash, peer):
            return False
        self.stats["deduped"] += 1
        _registry().meter("overlay.flood.duplicate").mark()
        return True

    def _recv_scp(self, peer: Peer, msg: X.StellarMessage,
                  body: Optional[bytes] = None,
                  body_hash: Optional[bytes] = None) -> None:
        env = msg.value
        if body is None:
            body = msg.to_xdr()
        h = body_hash if body_hash is not None else sha256(body)
        if not self.floodgate.add_record(h, env.statement.slotIndex, peer):
            self.stats["deduped"] += 1
            _registry().meter("overlay.flood.duplicate").mark()
            return
        status = self.herder.recv_scp_envelope(env)
        if status != "discarded":
            self._broadcast(msg, h, body)

    def _recv_transaction(self, peer: Peer, msg: X.StellarMessage) -> None:
        try:
            frame = self.herder.lm.make_frame(msg.value)
        except Exception:
            peer.drop("undecodable transaction")
            return
        h = frame.content_hash()
        if not self.floodgate.add_record(
                h, self.herder.tracking_consensus_ledger_index(), peer):
            self.stats["deduped"] += 1
            _registry().meter("overlay.flood.duplicate").mark()
            return
        res = self.herder.recv_transaction(frame, origin="overlay")
        if self.herder.admission is not None:
            # batched admission floods via on_admitted -> flood_transaction
            # once the frame actually verifies; re-advertising here would
            # announce txs that may still fail admission
            return
        if getattr(res, "code", None) == "pending":
            # re-advertise to everyone who hasn't seen it
            for p in self._auth_peer_list():
                if p not in self.floodgate.peers_told(h):
                    self.adverts.queue_advert(p, h)

    def _recv_advert(self, peer: Peer, hashes: List[bytes]) -> None:
        demand = [h for h in hashes if not self.floodgate.seen(h)]
        if demand:
            self._send_demand(peer, demand[:X.TX_DEMAND_VECTOR_MAX_SIZE])

    def _recv_demand(self, peer: Peer, hashes: List[bytes]) -> None:
        for h in hashes:
            frame = self.herder.tx_queue.by_hash.get(h)
            if frame is not None:
                peer.send_message(X.StellarMessage.transaction(
                    frame.envelope))
                self.floodgate.note_told(h, peer)

    def _serve_txset(self, peer: Peer, h: bytes) -> None:
        got = self.herder.pending.get_txset(h)
        if got is not None:
            self.stats["txsets_served"] += 1
            txset = got[0]
            if isinstance(txset, X.GeneralizedTransactionSet):
                peer.send_message(X.StellarMessage.generalizedTxSet(txset))
            else:
                peer.send_message(X.StellarMessage.txSet(txset))
        else:
            peer.send_message(X.StellarMessage.dontHave(X.DontHave(
                type=X.MessageType.GET_TX_SET, reqHash=h)))

    def _serve_qset(self, peer: Peer, h: bytes) -> None:
        qs = self.herder.pending.get_qset(h)
        if qs is not None:
            self.stats["qsets_served"] += 1
            peer.send_message(X.StellarMessage.qSet(qs))
        else:
            peer.send_message(X.StellarMessage.dontHave(X.DontHave(
                type=X.MessageType.GET_SCP_QUORUMSET, reqHash=h)))
