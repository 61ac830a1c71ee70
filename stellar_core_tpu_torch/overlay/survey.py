"""SurveyManager: time-sliced network-topology survey.

Reference: src/overlay/SurveyManager.{h,cpp} + SurveyDataManager — a
surveyor broadcasts a signed *start-collecting* message (scoped by a nonce);
every node relays it and starts recording peer/node stats; the surveyor then
sends signed per-node *requests*, each carrying an ephemeral Curve25519 key;
surveyed nodes reply with their recorded ``TopologyResponseBodyV2``
encrypted to that key; a signed *stop-collecting* ends the slice.  Results
feed the `/surveytopologytimesliced` + `/getsurveyresult` admin endpoints.

Survey messages flood through the overlay like SCP traffic (signature- and
nonce-gated), so non-neighbour nodes can be surveyed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import xdr as X
from ..crypto import box
from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..util import logging as slog

log = slog.get("Overlay")

# one collecting phase may span at most this many ledgers (reference:
# SurveyDataManager::MAX_PHASE_DURATION ~ 30 min; scaled to ledgers here)
MAX_COLLECTING_LEDGERS = 120
MAX_RESPONSE_PEERS = 25
# relay-side nonce memory is attacker-writable (any permitted surveyor's
# START registers one) — hard-cap it
MAX_KNOWN_NONCES = 64


class CollectingState:
    """Stats recorded on a surveyed node between start/stop collecting."""

    __slots__ = ("surveyor", "nonce", "start_ledger", "added_peers",
                 "dropped_peers", "lost_sync_count")

    def __init__(self, surveyor: bytes, nonce: int, start_ledger: int):
        self.surveyor = surveyor
        self.nonce = nonce
        self.start_ledger = start_ledger
        self.added_peers = 0
        self.dropped_peers = 0
        self.lost_sync_count = 0


class SurveyManager:
    def __init__(self, overlay, node_secret: SecretKey):
        self.overlay = overlay
        self.node_secret = node_secret
        # surveyed side
        self.collecting: Optional[CollectingState] = None
        # surveyor side
        self._nonce: Optional[int] = None
        self._enc_sk: Optional[bytes] = None
        self._enc_pk: Optional[bytes] = None
        self._results: Dict[bytes, dict] = {}   # surveyed node id -> body
        self._bad_response_nodes: List[str] = []
        self._last_nonce: Optional[int] = None
        # relay side: nonces of surveys seen via a valid start-collecting
        # (nonce -> (surveyor node id, start ledgerNum)).  A relay node that
        # could not adopt the collecting phase (e.g. another survey was
        # live, or its own phase expired) must still forward requests for a
        # known active survey — the reference relays on the nonce belonging
        # to an active survey, not on local collecting state.  The surveyor
        # binding prevents an unprivileged peer from riding a live nonce
        # (relay amplification) or forging a stop that kills relaying.
        self._known_nonces: Dict[int, tuple] = {}

    # -- signing helpers -----------------------------------------------------
    # Domain-separated: start/stop (and request/response) messages have
    # identical XDR layouts, so signing raw XDR would let a signed START
    # replay as a valid STOP.  The reference signs type-tagged payloads
    # (SurveyManager signs ENVELOPE_TYPE-prefixed XDR); here each message
    # kind gets its own tag prefix.
    def _sign(self, tag: bytes, payload: bytes) -> bytes:
        return self.node_secret.sign(tag + payload)

    @staticmethod
    def _verify(node_id: bytes, tag: bytes, payload: bytes,
                sig: bytes) -> bool:
        from ..crypto import sodium
        return sodium.verify_detached(sig, tag + payload, node_id)

    TAG_START = b"surveyStartCollecting"
    TAG_STOP = b"surveyStopCollecting"
    TAG_REQUEST = b"surveyRequest"
    TAG_RESPONSE = b"surveyResponse"

    # -- surveyor side -------------------------------------------------------
    def start_survey(self, nonce: Optional[int] = None) -> int:
        """Broadcast start-collecting; returns the nonce identifying the
        run (reference: SurveyManager::broadcastStartSurveyCollecting)."""
        if nonce is None:
            import random
            nonce = random.getrandbits(32)
        self._nonce = nonce
        self._enc_pk, self._enc_sk = box.keypair()
        self._results = {}
        self._bad_response_nodes = []
        msg = X.TimeSlicedSurveyStartCollectingMessage(
            surveyorID=X.NodeID.ed25519(self.overlay.node_id),
            nonce=nonce,
            ledgerNum=self._ledger_num())
        signed = X.SignedTimeSlicedSurveyStartCollectingMessage(
            signature=self._sign(self.TAG_START, msg.to_xdr()),
            startCollecting=msg)
        sm = X.StellarMessage.signedTimeSlicedSurveyStartCollectingMessage(
            signed)
        self._flood(sm)
        # the surveyor records itself too
        self.recv_start_collecting(None, signed)
        return nonce

    def send_request(self, surveyed_node_id: bytes) -> None:
        """Signed, addressed survey request (reference:
        SurveyManager::sendTopologyRequest)."""
        if self._nonce is None:
            raise RuntimeError("no active survey")
        req = X.TimeSlicedSurveyRequestMessage(
            request=X.SurveyRequestMessage(
                surveyorPeerID=X.NodeID.ed25519(self.overlay.node_id),
                surveyedPeerID=X.NodeID.ed25519(surveyed_node_id),
                ledgerNum=self._ledger_num(),
                encryptionKey=X.Curve25519Public(key=self._enc_pk)),
            nonce=self._nonce)
        signed = X.SignedTimeSlicedSurveyRequestMessage(
            requestSignature=self._sign(self.TAG_REQUEST, req.to_xdr()),
            request=req)
        self._flood(
            X.StellarMessage.signedTimeSlicedSurveyRequestMessage(signed))

    def stop_survey(self) -> None:
        """Broadcast stop-collecting (reference:
        broadcastStopSurveyCollecting)."""
        if self._nonce is None:
            return
        msg = X.TimeSlicedSurveyStopCollectingMessage(
            surveyorID=X.NodeID.ed25519(self.overlay.node_id),
            nonce=self._nonce,
            ledgerNum=self._ledger_num())
        signed = X.SignedTimeSlicedSurveyStopCollectingMessage(
            signature=self._sign(self.TAG_STOP, msg.to_xdr()),
            stopCollecting=msg)
        self._flood(
            X.StellarMessage.signedTimeSlicedSurveyStopCollectingMessage(
                signed))
        self.recv_stop_collecting(None, signed)
        # the surveyor's run is over: allow a fresh start_survey later;
        # accumulated results stay readable via results()
        self._last_nonce = self._nonce
        self._nonce = None

    def results(self) -> dict:
        """The `/getsurveyresult` payload (reference:
        SurveyManager::getJsonResults)."""
        return {
            "surveyInProgress": self._nonce is not None,
            "nonce": self._nonce if self._nonce is not None
                     else self._last_nonce,
            "topology": {nid.hex(): body
                         for nid, body in self._results.items()},
            "badResponseNodes": self._bad_response_nodes,
        }

    # -- surveyed side -------------------------------------------------------
    def _surveyor_permitted(self, surveyor: bytes) -> bool:
        """Only nodes in the local transitive quorum (or self) may survey
        (reference: SurveyManager::surveyorPermitted — surveyors outside
        the quorum map are ignored so arbitrary peers cannot harvest
        topology or disrupt running surveys)."""
        if surveyor == self.overlay.node_id:
            return True
        herder = self.overlay.herder
        qmap = herder.quorum_map()
        if surveyor in qmap:
            return True
        from ..scp.quorum import qset_nodes
        for qset in qmap.values():
            if qset is not None and surveyor in qset_nodes(qset):
                return True
        return False

    def recv_start_collecting(self, peer, signed) -> bool:
        """Returns True if the message is fresh/valid (and should be
        relayed)."""
        msg = signed.startCollecting
        surveyor = msg.surveyorID.value
        if not self._surveyor_permitted(surveyor):
            return False
        if not self._verify(surveyor, self.TAG_START, msg.to_xdr(),
                            signed.signature):
            return False
        self.maybe_expire()
        # remember the nonce (bound to its surveyor) for request relaying
        # even when we cannot adopt the collecting phase locally.
        # First-writer wins: a later START reusing a live nonce must not
        # rebind it to a different surveyor (hijack).  The expiry basis is
        # OUR ledger, not the message's claimed ledgerNum — an attacker-
        # chosen ledgerNum far in the future would pin the entry forever.
        if msg.nonce not in self._known_nonces \
                and len(self._known_nonces) < MAX_KNOWN_NONCES:
            self._known_nonces[msg.nonce] = (surveyor, self._ledger_num())
        if self.collecting is not None:
            # one survey at a time; a fresh START must not clobber a live
            # collecting phase (an abandoned one expires via maybe_expire)
            return False
        # clamp the phase start to OUR ledger: a claimed far-future
        # ledgerNum would make the phase unexpirable and block every
        # future survey on this node
        self.collecting = CollectingState(
            surveyor, msg.nonce, min(msg.ledgerNum, self._ledger_num()))
        return True

    def recv_stop_collecting(self, peer, signed) -> bool:
        msg = signed.stopCollecting
        if not self._verify(msg.surveyorID.value, self.TAG_STOP,
                            msg.to_xdr(), signed.signature):
            return False
        # only the surveyor who started the survey may stop it — a stop
        # self-signed by any other peer must neither clear the nonce nor
        # be relayed
        entry = self._known_nonces.get(msg.nonce)
        known = entry is not None and entry[0] == msg.surveyorID.value
        if known:
            del self._known_nonces[msg.nonce]
        if self.collecting is None or self.collecting.nonce != msg.nonce \
                or self.collecting.surveyor != msg.surveyorID.value:
            # still relay a stop for a known survey so it reaches
            # collectors behind this node
            return known
        self.collecting = None
        return True

    def recv_request(self, peer, signed) -> bool:
        """Validate; if addressed to us, respond.  Returns relay verdict."""
        req = signed.request
        inner = req.request
        surveyor = inner.surveyorPeerID.value
        if not self._verify(surveyor, self.TAG_REQUEST, req.to_xdr(),
                            signed.requestSignature):
            return False
        self.maybe_expire()
        local = (self.collecting is not None
                 and self.collecting.nonce == req.nonce
                 and self.collecting.surveyor == surveyor)
        if inner.surveyedPeerID.value != self.overlay.node_id:
            # relay toward the surveyed node whenever the nonce belongs to
            # a known active survey AND the request comes from the surveyor
            # who started it, even if this node missed/expired the
            # collecting phase — nodes behind us may still be collecting
            entry = self._known_nonces.get(req.nonce)
            return local or (entry is not None and entry[0] == surveyor)
        if not local:
            return False  # addressed to us but we are not in this run
        body = self._build_response_body()
        blob = box.seal(inner.encryptionKey.key, body.to_xdr())
        resp = X.TimeSlicedSurveyResponseMessage(
            response=X.SurveyResponseMessage(
                surveyorPeerID=inner.surveyorPeerID,
                surveyedPeerID=inner.surveyedPeerID,
                ledgerNum=inner.ledgerNum,
                encryptedBody=blob),
            nonce=req.nonce)
        signed_resp = X.SignedTimeSlicedSurveyResponseMessage(
            responseSignature=self._sign(self.TAG_RESPONSE, resp.to_xdr()),
            response=resp)
        self._flood(
            X.StellarMessage.signedTimeSlicedSurveyResponseMessage(
                signed_resp))
        return True

    def recv_response(self, peer, signed) -> bool:
        resp = signed.response
        inner = resp.response
        surveyed = inner.surveyedPeerID.value
        if not self._verify(surveyed, self.TAG_RESPONSE, resp.to_xdr(),
                            signed.responseSignature):
            return False
        if inner.surveyorPeerID.value != self.overlay.node_id:
            return True   # relay toward the surveyor
        if self._nonce is None or resp.nonce != self._nonce:
            return False
        try:
            body_xdr = box.seal_open(self._enc_sk, bytes(inner.encryptedBody))
            body = X.SurveyResponseBody.from_xdr(body_xdr)
        except Exception as e:
            log.warning("undecryptable survey response from %s: %s",
                        surveyed.hex()[:8], e)
            self._bad_response_nodes.append(surveyed.hex())
            return False
        self._results[surveyed] = _body_to_json(body.value)
        return False  # addressed to us — no further relay

    # -- shared --------------------------------------------------------------
    def record_added_peer(self) -> None:
        if self.collecting is not None:
            self.collecting.added_peers += 1

    def record_dropped_peer(self) -> None:
        if self.collecting is not None:
            self.collecting.dropped_peers += 1

    def record_lost_sync(self) -> None:
        if self.collecting is not None:
            self.collecting.lost_sync_count += 1

    def maybe_expire(self) -> None:
        """Collecting phases time out rather than lingering (reference:
        SurveyDataManager::updateSurveyPhase)."""
        if self.collecting is not None and self._ledger_num() > \
                self.collecting.start_ledger + MAX_COLLECTING_LEDGERS:
            self.collecting = None
        now = self._ledger_num()
        stale = [n for n, (_sv, start) in self._known_nonces.items()
                 if now > start + MAX_COLLECTING_LEDGERS]
        for n in stale:
            del self._known_nonces[n]

    def _build_response_body(self) -> X.SurveyResponseBody:
        inbound, outbound = [], []
        for p in self.overlay._auth_peer_list():
            stats = X.TimeSlicedPeerData(peerStats=X.PeerStats(
                id=X.NodeID.ed25519(p.peer_id),
                versionStr=getattr(p, "remote_version_str", "") or "",
                messagesRead=p._recv_seq,
                messagesWritten=p._send_seq))
            bucket = outbound if p.we_called_remote else inbound
            if len(bucket) < MAX_RESPONSE_PEERS:
                bucket.append(stats)
        c = self.collecting
        node_data = X.TimeSlicedNodeData(
            addedAuthenticatedPeers=c.added_peers if c else 0,
            droppedAuthenticatedPeers=c.dropped_peers if c else 0,
            totalInboundPeerCount=len(inbound),
            totalOutboundPeerCount=len(outbound),
            lostSyncCount=c.lost_sync_count if c else 0,
            isValidator=1 if getattr(self.overlay.herder, "is_validator",
                                     True) else 0)
        return X.SurveyResponseBody.topologyResponseBodyV2(
            X.TopologyResponseBodyV2(inboundPeers=inbound,
                                     outboundPeers=outbound,
                                     nodeData=node_data))

    def _ledger_num(self) -> int:
        return self.overlay.herder.lm.last_closed_ledger_seq

    def _flood(self, sm: X.StellarMessage) -> None:
        h = sha256(sm.to_xdr())
        self.overlay.floodgate.add_record(h, self._ledger_num())
        self.overlay._broadcast(sm, h)


def _body_to_json(body: "X.TopologyResponseBodyV2") -> dict:
    def peers(lst):
        return [{
            "nodeId": pd.peerStats.id.value.hex(),
            "version": pd.peerStats.versionStr,
            "messagesRead": pd.peerStats.messagesRead,
            "messagesWritten": pd.peerStats.messagesWritten,
        } for pd in lst]
    nd = body.nodeData
    return {
        "inboundPeers": peers(body.inboundPeers),
        "outboundPeers": peers(body.outboundPeers),
        "nodeData": {
            "addedAuthenticatedPeers": nd.addedAuthenticatedPeers,
            "droppedAuthenticatedPeers": nd.droppedAuthenticatedPeers,
            "totalInbound": nd.totalInboundPeerCount,
            "totalOutbound": nd.totalOutboundPeerCount,
            "lostSyncCount": nd.lostSyncCount,
            "isValidator": bool(nd.isValidator),
        },
    }
