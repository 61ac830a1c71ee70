"""Peer: handshake + authenticated messaging + flow control state machine.

Reference: src/overlay/Peer.{h,cpp} (recvHello/recvAuth/recvAuthenticated
dispatch, DropReason semantics), src/overlay/FlowControl.{h,cpp}
(capacity-granted flood sending via SEND_MORE_EXTENDED), transport left to
subclasses (TCPPeer / LoopbackPeer, like the reference).

Wire format: RFC 5531 record marking — every frame is a 4-byte big-endian
header with the high bit set (single-fragment) and the payload length in
the low 31 bits, followed by an AuthenticatedMessage XDR.  HELLO and
ERROR_MSG travel with sequence 0 and a zero MAC (no keys yet); everything
else is HMAC'd with per-direction keys and strictly increasing sequences.

Batched transport (an extension of this implementation): when both sides set AUTH_FLAG_BATCH in
their AUTH, batch-eligible sends coalesce into a per-peer pending run that
flushes on a message/byte cap or on the next crank edge as ONE
BATCHED_AUTH frame — one sequence number + one MAC over the packed run
(AuthenticatedMessage arm 1, spliced from the already-encoded bodies).
Latency-sensitive types (AUTH, ERROR, SEND_MORE[_EXTENDED]) flush the run
and go out immediately as classic per-message frames, as does a run of
one, so a lone send keeps the unbatched wire format and latency.  Flow
control stays PER MESSAGE: capacity is debited per contained message on
send and earned per contained message on receive.
"""

from __future__ import annotations

import os
import struct
from typing import Callable, List, Optional

from .. import xdr as X
from ..crypto.sha import sha256
from ..util import logging as slog
from ..util.metrics import registry as _registry
from .peer_auth import PeerAuth, mac_message, mac_ok

log = slog.get("Overlay")

OVERLAY_PROTOCOL_VERSION = 38
OVERLAY_PROTOCOL_MIN_VERSION = 35
VERSION_STR = "stellar-core-tpu 2.0"

# flow control (reference: FlowControl::start — these are the capacities a
# node grants its peer when the connection authenticates)
PEER_FLOOD_READING_CAPACITY = 200
FLOW_CONTROL_SEND_MORE_BATCH = 40
PEER_FLOOD_READING_CAPACITY_BYTES = 300_000
FLOW_CONTROL_BYTES_BATCH = 100_000

_ZERO_MAC = b"\x00" * 32
# AuthenticatedMessage union discriminants (see _emit_authenticated /
# _emit_batch — both paths splice frames from pre-encoded bodies)
_AM_V0_ARM = b"\x00\x00\x00\x00"
_AM_BATCH_ARM = b"\x00\x00\x00\x01"

_FLOOD_TYPES = frozenset((
    X.MessageType.TRANSACTION, X.MessageType.SCP_MESSAGE,
    X.MessageType.FLOOD_ADVERT, X.MessageType.FLOOD_DEMAND))

# latency-sensitive types that must never wait in a coalescing run: the
# handshake pair, errors and flow-control grants (a grant riding a full
# batch would add exactly the stall it exists to break).  HELLO/ERROR
# travel unauthenticated anyway; listed for the avoidance of doubt.
_BATCH_IMMEDIATE = frozenset((
    X.MessageType.HELLO, X.MessageType.AUTH, X.MessageType.ERROR_MSG,
    X.MessageType.SEND_MORE, X.MessageType.SEND_MORE_EXTENDED))

# a batch is authenticated traffic between two completed handshakes:
# handshake/error messages inside one are protocol violations
_BATCH_FORBIDDEN = frozenset((
    X.MessageType.HELLO, X.MessageType.AUTH, X.MessageType.ERROR_MSG))

# StellarMessage's union discriminant is its first 4 XDR bytes — the batch
# receive path peeks it from the raw body to route SCP traffic through the
# pre-decode duplicate drop (flood dedup keys SCP on sha256 of the body)
_SCP_MESSAGE_SWITCH = int(X.MessageType.SCP_MESSAGE)


def frame_encode(payload: bytes) -> bytes:
    assert len(payload) < (1 << 31)
    return (0x80000000 | len(payload)).to_bytes(4, "big") + payload


class FrameDecoder:
    """Incremental record-mark deframer for a byte stream."""

    MAX_FRAME = 32 * 1024 * 1024

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        out = []
        while True:
            if len(self._buf) < 4:
                break
            header = int.from_bytes(self._buf[:4], "big")
            if not header & 0x80000000:
                raise ValueError("fragmented records not supported")
            length = header & 0x7FFFFFFF
            if length > self.MAX_FRAME:
                raise ValueError("oversized frame")
            if len(self._buf) < 4 + length:
                break
            out.append(bytes(self._buf[4:4 + length]))
            del self._buf[:4 + length]
        return out


class Peer:
    # connection states (reference: Peer::State)
    CONNECTING = "connecting"
    CONNECTED = "connected"      # transport up, HELLO exchange in flight
    GOT_HELLO = "got-hello"
    GOT_AUTH = "authenticated"
    CLOSING = "closing"

    def __init__(self, overlay, we_called_remote: bool):
        self.overlay = overlay
        self.auth: PeerAuth = overlay.peer_auth
        self.we_called_remote = we_called_remote
        self.state = Peer.CONNECTING
        self.peer_id: Optional[bytes] = None       # remote ed25519
        self.remote_listening_port: int = 0
        self.local_nonce = os.urandom(32)
        self._decoder = FrameDecoder()
        self._send_seq = 0
        self._recv_seq = 0
        self._send_key: Optional[bytes] = None
        self._recv_key: Optional[bytes] = None
        self.drop_reason: Optional[str] = None
        # flow control
        self._outbound_capacity = 0
        self._outbound_capacity_bytes = 0
        self._flood_queue: List[X.StellarMessage] = []
        self._processed_since_grant = 0
        self._processed_bytes_since_grant = 0
        # back-pressure: grants the admission pipeline told us to hold —
        # (messages, bytes) owed to the peer once the backlog drains
        self._deferred_grant: Optional[List[int]] = None
        # batched transport: local willingness (flipped per-peer by tests;
        # seeded from the overlay's config knob), what we advertised in
        # our AUTH, what the remote advertised in theirs, and the pending
        # coalescing run of pre-encoded bodies
        self.batching_enabled: bool = bool(overlay.batching)
        self._advertised_batch = False
        self._remote_batch = False
        self._batch_run: List[bytes] = []
        self._batch_bytes = 0
        self._batch_flush_armed = False
        self._batch_max_msgs = overlay.batch_max_messages
        self._batch_max_bytes = overlay.batch_max_bytes
        # wire accounting metric objects, cached for the peer's lifetime
        reg = _registry()
        self._ctr_byte_read = reg.counter("overlay.byte.read")
        self._ctr_byte_write = reg.counter("overlay.byte.write")
        self._met_msg_read = reg.meter("overlay.message.read")
        self._met_msg_write = reg.meter("overlay.message.write")
        self._met_batch_msgs = reg.meter("overlay.batch.messages")
        self._met_batch_flush = reg.meter("overlay.batch.flush")
        self._ctr_batch_bytes = reg.counter("overlay.batch.bytes")

    # -- transport interface (subclass-provided) ----------------------------
    def _write_bytes(self, data: bytes) -> None:
        raise NotImplementedError

    def _close_transport(self) -> None:
        raise NotImplementedError

    # -- lifecycle ----------------------------------------------------------
    def connect_handler(self) -> None:
        """Transport established.  The dialer speaks first (reference:
        TCPPeer::connectHandler -> sendHello)."""
        self.state = Peer.CONNECTED
        if self.we_called_remote:
            self.send_hello()

    def drop(self, reason: str) -> None:
        if self.state == Peer.CLOSING:
            return
        self.drop_reason = reason
        self.state = Peer.CLOSING
        self._batch_run = []
        self._batch_bytes = 0
        log.info("dropping peer %s: %s",
                 self.peer_id.hex()[:8] if self.peer_id else "?", reason)
        self._close_transport()
        self.overlay._peer_dropped(self)

    def is_authenticated(self) -> bool:
        return self.state == Peer.GOT_AUTH

    # -- sending ------------------------------------------------------------
    def send_hello(self) -> None:
        lcl = self.overlay.ledger_version()
        msg = X.StellarMessage.hello(X.Hello(
            ledgerVersion=lcl,
            overlayVersion=OVERLAY_PROTOCOL_VERSION,
            overlayMinVersion=OVERLAY_PROTOCOL_MIN_VERSION,
            networkID=self.overlay.network_id,
            versionStr=VERSION_STR,
            listeningPort=self.overlay.listening_port,
            peerID=X.NodeID.ed25519(self.overlay.node_id),
            cert=self.auth.get_cert(),
            nonce=self.local_nonce))
        self._send_unauthenticated(msg)

    def send_error(self, code, text: str) -> None:
        self._send_unauthenticated(X.StellarMessage.error(
            X.Error(code=code, msg=text)))

    def _send_unauthenticated(self, msg: X.StellarMessage) -> None:
        # an ERROR racing a pending run must land AFTER it (frame order =
        # send order); HELLO happens before keys exist, run empty
        self._flush_batch()
        am = X.AuthenticatedMessage.v0(X.AuthenticatedMessageV0(
            sequence=0, message=msg, mac=X.HmacSha256Mac(mac=_ZERO_MAC)))
        self._write_frame(frame_encode(am.to_xdr()))

    def _write_frame(self, data: bytes) -> None:
        # wire-level accounting: framed bytes + messages out (reference:
        # the overlay byte/message write medida meters in Peer); metric
        # objects are cached per peer — a registry lookup per frame is
        # measurable at simulated-fleet message rates
        self._ctr_byte_write.inc(len(data))
        self._met_msg_write.mark()
        self._write_bytes(data)

    def send_message(self, msg: X.StellarMessage,
                     body: Optional[bytes] = None) -> None:
        """Authenticated send; flood messages respect granted capacity and
        queue when the peer hasn't given us room (reference:
        FlowControl::maybeSendMessage).  The XDR body is encoded exactly
        once and threaded through queueing, size accounting and the MAC —
        callers broadcasting one message to many peers pass the shared
        encoding via `body`."""
        if self.state == Peer.CLOSING:
            return
        if body is None:
            body = msg.to_xdr()
        if msg.switch in _FLOOD_TYPES:
            if self._outbound_capacity <= 0 \
                    or self._outbound_capacity_bytes < len(body):
                self._flood_queue.append((msg, body))
                return
            self._outbound_capacity -= 1
            self._outbound_capacity_bytes -= len(body)
        self._send_authenticated(msg, body)

    def _send_authenticated(self, msg: X.StellarMessage,
                            body: Optional[bytes] = None) -> None:
        if self._send_key is None:
            self.drop("send before auth keys")
            return
        if body is None:
            body = msg.to_xdr()
        if self._remote_batch and self.batching_enabled \
                and msg.switch not in _BATCH_IMMEDIATE:
            self._batch_append(body)
            return
        # immediate types (and everything on an unbatched link) preserve
        # send order: drain the pending run before emitting — which is
        # also how a deferred-grant release rides a batch flush
        self._flush_batch()
        self._emit_authenticated(body)

    def _emit_authenticated(self, body: bytes) -> None:
        mac = mac_message(self._send_key, self._send_seq, body)
        # splice the AuthenticatedMessage from the already-encoded body
        # instead of re-packing the whole message through the codec:
        # union arm v0 (uint32 0) + sequence (uint64) + message + 32-byte
        # MAC.  Byte-identical to the object path (unit-tested) and the
        # dominant per-link cost of a fleet-wide flood at 300 simulated
        # nodes.
        am_xdr = _AM_V0_ARM + struct.pack(">Q", self._send_seq) + body + mac
        self._send_seq += 1
        self._write_frame(frame_encode(am_xdr))

    # -- batched transport (send side) --------------------------------------
    def _batch_append(self, body: bytes) -> None:
        self._batch_run.append(body)
        self._batch_bytes += len(body)
        if len(self._batch_run) >= self._batch_max_msgs \
                or self._batch_bytes >= self._batch_max_bytes:
            self._flush_batch()
        elif not self._batch_flush_armed:
            # crank-edge flush: ONE posted action per empty->nonempty
            # edge.  A lone message still leaves within the current crank
            # round (no flush-delay regression), while a broadcast storm
            # appending N bodies this crank rides out as one frame.
            self._batch_flush_armed = True
            self.overlay.clock.post_action(self._crank_flush,
                                           name="overlay-batch-flush")

    def _crank_flush(self) -> None:
        self._batch_flush_armed = False
        if self.state != Peer.CLOSING:
            self._flush_batch()

    def _flush_batch(self) -> None:
        run = self._batch_run
        if not run:
            return
        self._batch_run = []
        self._batch_bytes = 0
        if len(run) == 1:
            # a run of one goes out as a classic per-message frame: the
            # batched link's quiet-path wire bytes and latency are
            # identical to an unbatched link's
            self._emit_authenticated(run[0])
            return
        self._emit_batch(run)

    def _emit_batch(self, run: List[bytes]) -> None:
        self._write_frame(self._build_batch_frame(run))

    def _build_batch_frame(self, run: List[bytes]) -> bytes:
        """Splice one BATCHED_AUTH frame: union arm 1 + sequence + packed
        run (count + per-body length prefix; bodies are XDR encodings so
        they are already 4-aligned) + one MAC over the packed run.
        Byte-identical to the BatchedAuthenticatedMessage codec path
        (unit-tested) without re-encoding any body."""
        payload = bytearray(struct.pack(">I", len(run)))
        for body in run:
            payload += struct.pack(">I", len(body))
            payload += body
        payload = bytes(payload)
        mac = mac_message(self._send_key, self._send_seq, payload)
        am_xdr = _AM_BATCH_ARM + struct.pack(">Q", self._send_seq) \
            + payload + mac
        self._send_seq += 1
        self._met_batch_msgs.mark(len(run))
        self._met_batch_flush.mark()
        self._ctr_batch_bytes.inc(len(am_xdr))
        return frame_encode(am_xdr)

    def _flush_flood_queue(self) -> None:
        while self._flood_queue and self._outbound_capacity > 0:
            msg, body = self._flood_queue[0]
            if self._outbound_capacity_bytes < len(body):
                break
            self._flood_queue.pop(0)
            self._outbound_capacity -= 1
            self._outbound_capacity_bytes -= len(body)
            self._send_authenticated(msg, body)

    @property
    def flood_queue_len(self) -> int:
        return len(self._flood_queue)

    # -- receiving ----------------------------------------------------------
    def data_received(self, data: bytes) -> None:
        self._ctr_byte_read.inc(len(data))
        try:
            frames = self._decoder.feed(data)
        except ValueError as e:
            self.drop(f"bad framing: {e}")
            return
        for frame in frames:
            if self.state == Peer.CLOSING:
                return
            self._met_msg_read.mark()
            self._frame_received(frame)

    def _frame_received(self, frame: bytes) -> None:
        if frame[:4] == _AM_BATCH_ARM:
            self._batch_frame_received(frame)
            return
        try:
            am = X.AuthenticatedMessage.from_xdr(frame)
        except Exception:
            self.drop("undecodable message")
            return
        v0 = am.value
        msg = v0.message
        if msg.switch == X.MessageType.HELLO:
            if v0.sequence != 0 or v0.mac.mac != _ZERO_MAC:
                self.drop("HELLO must be unauthenticated")
                return
            self._recv_hello(msg.value)
            return
        if msg.switch == X.MessageType.ERROR_MSG:
            err = msg.value
            self.drop(f"peer error: {err.code.name} "
                      f"{err.msg.decode(errors='replace')}")
            return
        # everything else requires the MAC chain.  The MAC'd body is the
        # frame minus the 4-byte union arm, the 8-byte sequence and the
        # trailing 32-byte MAC — sliced instead of re-encoding the
        # message the codec just decoded (the decode above already
        # proved the frame is exactly this shape).
        if self._recv_key is None:
            self.drop("authenticated message before HELLO exchange")
            return
        body = frame[12:len(frame) - 32]
        if v0.sequence != self._recv_seq \
                or not mac_ok(self._recv_key, v0.sequence, body, v0.mac.mac):
            self.drop("bad MAC or sequence")
            return
        self._recv_seq += 1
        if msg.switch == X.MessageType.AUTH:
            self._recv_auth(msg.value)
            return
        if not self.is_authenticated():
            self.drop("message before AUTH")
            return
        self._account_flood_processing(msg, len(body))
        self.overlay._message_received(self, msg, body=body)

    def _batch_frame_received(self, frame: bytes) -> None:
        """One BATCHED_AUTH frame: verify the single sequence + MAC over
        the packed run, then slice and dispatch each contained body
        through the exact per-message recv path.  EVERY body is decoded
        before ANY is dispatched — a malformed run from a keyed peer
        fail-stops with nothing partially delivered."""
        if self._recv_key is None:
            self.drop("authenticated message before HELLO exchange")
            return
        if not self._advertised_batch:
            # we never offered AUTH_FLAG_BATCH on this link: a compliant
            # peer cannot send arm-1 frames here
            self.drop("unnegotiated batch frame")
            return
        if len(frame) < 48:   # arm + sequence + count + MAC
            self.drop("bad batch framing")
            return
        sequence = struct.unpack_from(">Q", frame, 4)[0]
        payload = frame[12:len(frame) - 32]
        if sequence != self._recv_seq or not mac_ok(
                self._recv_key, sequence, payload, frame[len(frame) - 32:]):
            self.drop("bad MAC or sequence")
            return
        self._recv_seq += 1
        if not self.is_authenticated():
            self.drop("message before AUTH")
            return
        count = struct.unpack_from(">I", payload, 0)[0]
        if count == 0 or count > X.BATCH_WIRE_MAX_MESSAGES:
            self.drop("bad batch framing")
            return
        msgs = []
        off, end = 4, len(payload)
        for _ in range(count):
            if off + 4 > end:
                self.drop("bad batch framing")
                return
            ln = struct.unpack_from(">I", payload, off)[0]
            off += 4
            if ln > end - off:
                self.drop("bad batch framing")
                return
            body = payload[off:off + ln]
            off += ln
            h = None
            if ln >= 4 \
                    and struct.unpack_from(">I", body, 0)[0] \
                    == _SCP_MESSAGE_SWITCH:
                # pre-decode duplicate drop: SCP flood dedup keys on
                # sha256 of exactly these bytes, so a hash hit means the
                # body is byte-identical to a message that already
                # decoded cleanly — validity holds without re-decoding,
                # and at fleet scale most deliveries land here
                h = sha256(body)
                if self.overlay.flood_seen(h):
                    msgs.append((None, body, h))
                    continue
            try:
                msg = X.StellarMessage.from_xdr(body)
            except Exception:
                self.drop("undecodable message")
                return
            if msg.switch in _BATCH_FORBIDDEN:
                self.drop("bad batch framing")
                return
            msgs.append((msg, body, h))
        if off != end:
            self.drop("bad batch framing")
            return
        # data_received marked message.read once for the frame; make the
        # meter count contained messages, not frames
        self._met_msg_read.mark(len(msgs) - 1)
        for msg, body, h in msgs:
            if self.state == Peer.CLOSING:
                return   # a handler dropped us mid-run: stop dispatching
            if msg is None:
                # duplicate fast path: flow-control capacity is still
                # earned per contained message and the sender is noted
                # on the flood record so broadcast never echoes back
                self._account_flood_switch(X.MessageType.SCP_MESSAGE,
                                           len(body))
                if self.overlay._note_flood_duplicate(self, h):
                    continue
                # record GC'd between validation and dispatch (a ledger
                # close mid-run ran clear_below): take the decoded path
                try:
                    msg = X.StellarMessage.from_xdr(body)
                except Exception:
                    self.drop("undecodable message")
                    return
                self.overlay._message_received(self, msg, body=body,
                                               body_hash=h)
                continue
            # flow-control capacity is earned PER CONTAINED MESSAGE —
            # grants under batching account identically to per-frame mode
            self._account_flood_processing(msg, len(body))
            self.overlay._message_received(self, msg, body=body,
                                           body_hash=h)

    def _recv_hello(self, hello) -> None:
        if self.state not in (Peer.CONNECTED, Peer.CONNECTING):
            self.drop("HELLO out of order")
            return
        if hello.networkID != self.overlay.network_id:
            self.send_error(X.ErrorCode.ERR_CONF, "wrong network")
            self.drop("wrong network id")
            return
        if hello.overlayVersion < OVERLAY_PROTOCOL_MIN_VERSION:
            self.send_error(X.ErrorCode.ERR_CONF, "overlay version too old")
            self.drop("overlay version")
            return
        peer_id = hello.peerID.value
        if peer_id == self.overlay.node_id:
            self.drop("connected to self")
            return
        if not self.auth.verify_remote_cert(hello.cert, peer_id):
            self.send_error(X.ErrorCode.ERR_AUTH, "bad auth cert")
            self.drop("bad auth cert")
            return
        self.peer_id = peer_id
        self.remote_listening_port = hello.listeningPort
        self._send_key, self._recv_key = self.auth.shared_keys(
            hello.cert.pubkey.key, self.local_nonce, hello.nonce,
            self.we_called_remote)
        self.state = Peer.GOT_HELLO
        if not self.we_called_remote:
            self.send_hello()
        else:
            self._send_auth()

    def _send_auth(self) -> None:
        """Our half of the AUTH exchange; advertises AUTH_FLAG_BATCH when
        this side is willing to speak the batched transport.  The flag is
        informational to peers that predate it (they read flags as 0-or-
        whatever and ignore it), so the handshake stays byte-compatible."""
        flags = X.AUTH_FLAG_BATCH if self.batching_enabled else 0
        self._advertised_batch = bool(flags)
        self._send_authenticated(X.StellarMessage.auth(X.Auth(flags=flags)))

    def _recv_auth(self, auth: X.Auth) -> None:
        if self.state != Peer.GOT_HELLO:
            self.drop("AUTH out of order")
            return
        # batching is active only when BOTH sides advertised the flag —
        # a flags=0 peer keeps today's per-message wire format verbatim
        self._remote_batch = bool(auth.flags & X.AUTH_FLAG_BATCH)
        if not self.we_called_remote:
            # acceptor completes the handshake with its own AUTH
            self._send_auth()
        self.state = Peer.GOT_AUTH
        self._grant_capacity(initial=True)
        self.overlay._peer_authenticated(self)

    # -- flow control -------------------------------------------------------
    def _grant_capacity(self, initial: bool = False) -> None:
        if initial:
            self.send_message(X.StellarMessage.sendMoreExtendedMessage(
                X.SendMoreExtended(
                    numMessages=PEER_FLOOD_READING_CAPACITY,
                    numBytes=PEER_FLOOD_READING_CAPACITY_BYTES)))

    def _account_flood_processing(self, msg: X.StellarMessage,
                                  size: int) -> None:
        """Receiver side: periodically hand the sender fresh capacity.
        Grants trigger on EITHER the message-count or the byte threshold
        (reference: FlowControl::maybeSendNextBatch does both) — otherwise
        a few large messages could exhaust the sender's byte allowance
        before the message counter ever reaches the batch size, stalling
        the connection permanently."""
        if msg.switch == X.MessageType.SEND_MORE:
            self._outbound_capacity += msg.value.numMessages
            self._outbound_capacity_bytes += FLOW_CONTROL_BYTES_BATCH
            self._flush_flood_queue()
            return
        if msg.switch == X.MessageType.SEND_MORE_EXTENDED:
            self._outbound_capacity += msg.value.numMessages
            self._outbound_capacity_bytes += msg.value.numBytes
            self._flush_flood_queue()
            return
        self._account_flood_switch(msg.switch, size)

    def _account_flood_switch(self, switch, size: int) -> None:
        """Grant-earning half of flow accounting, keyed on the message
        type discriminant alone — the batch path's pre-decode duplicate
        drop accounts here without ever materialising the message."""
        if switch in _FLOOD_TYPES:
            self._processed_since_grant += 1
            self._processed_bytes_since_grant += size
            if (self._processed_since_grant >= FLOW_CONTROL_SEND_MORE_BATCH
                    or self._processed_bytes_since_grant
                    >= FLOW_CONTROL_BYTES_BATCH):
                n = self._processed_since_grant
                nb = self._processed_bytes_since_grant
                self._processed_since_grant = 0
                self._processed_bytes_since_grant = 0
                if self.overlay.flood_grants_paused():
                    # admission back-pressure: the capacity is EARNED but
                    # not granted — the sender stays throttled until the
                    # local backlog drains, then the deferred grant ships
                    # in one SEND_MORE_EXTENDED (release_deferred_grant)
                    if self._deferred_grant is None:
                        self._deferred_grant = [0, 0]
                    self._deferred_grant[0] += n
                    self._deferred_grant[1] += nb
                    _registry().meter("overlay.flood.grant-deferred").mark()
                    return
                self.send_message(X.StellarMessage.sendMoreExtendedMessage(
                    X.SendMoreExtended(numMessages=n, numBytes=nb)))

    def release_deferred_grant(self) -> None:
        """Ship every flow-control grant withheld while admission was
        back-pressured (overlay_manager.release_flood_grants)."""
        if self._deferred_grant is None or self.state != Peer.GOT_AUTH:
            return
        n, nb = self._deferred_grant
        self._deferred_grant = None
        if n or nb:
            self.send_message(X.StellarMessage.sendMoreExtendedMessage(
                X.SendMoreExtended(numMessages=n, numBytes=nb)))


class LoopbackPeer(Peer):
    """In-process transport for deterministic tests (reference:
    src/overlay/test/LoopbackPeer) — bytes are delivered to the partner via
    clock-posted actions, so delivery interleaves with timers.

    Delivery is COALESCED per crank: every frame surviving fault injection
    joins a pending run, and one posted action per crank hands the whole
    run to the partner through a single data_received call — one scheduler
    dispatch per link-direction per crank instead of one per message,
    which is the sim-level half of the batched-transport speedup.  Fault
    semantics are unchanged: drop/damage/reorder draws stay per frame (and
    per contained message for BATCHED_AUTH frames, see _emit_batch)."""

    def __init__(self, overlay, we_called_remote: bool,
                 fault_rng=None):
        super().__init__(overlay, we_called_remote)
        self.partner: Optional["LoopbackPeer"] = None
        # fault-injection knobs (reference: LoopbackPeer's damage/drop/
        # reorder probabilities used by overlay tests).  The RNG feeding
        # them is injectable: the Simulation derives one seeded stream per
        # loopback pair so an entire chaos campaign replays bit-identically
        # from its logged seed; standalone tests keep the fixed default.
        self.drop_outbound = False       # black hole
        self.damage_probability = 0.0    # flip a byte in outbound frames
        self.drop_probability = 0.0      # silently drop outbound frames
        self.reorder_probability = 0.0   # delay a frame behind the next
        if fault_rng is None:
            import random as _random
            fault_rng = _random.Random(0)  # deterministic by default
        self.fault_rng = fault_rng
        self._held_back: Optional[bytes] = None
        self._backstop_gen = 0
        self._pending_out: List[bytes] = []
        self._delivery_armed = False

    def _write_bytes(self, data: bytes) -> None:
        if self.partner is None or self.drop_outbound:
            return
        rng = self.fault_rng
        held, self._held_back = self._held_back, None
        frames = []
        dropped = (self.drop_probability
                   and rng.random() < self.drop_probability)
        if not dropped:
            if self.damage_probability \
                    and rng.random() < self.damage_probability \
                    and len(data) > 4:
                # flip a PAYLOAD bit (offset >= 4): damaging the record
                # mark/length would stall the frame decoder rather than
                # exercise the MAC fail-stop (reference: LoopbackPeer
                # damages message bodies)
                buf = bytearray(data)
                buf[rng.randrange(4, len(buf))] ^= 1 << rng.randrange(8)
                data = bytes(buf)
            if self.reorder_probability \
                    and rng.random() < self.reorder_probability \
                    and held is None:
                # delivered behind the NEXT frame; a posted backstop keeps
                # quiesced traffic from turning 'reorder' into 'drop'
                self._held_back = data
                self._arm_backstop()
            else:
                frames.append(data)
        if held is not None:
            # the previously held frame lands AFTER this one (that's the
            # reorder) — and even if this frame was dropped, the held one
            # must not be silently lost
            frames.append(held)
        for frame in frames:
            self._enqueue_delivery(frame)

    def _enqueue_delivery(self, data: bytes) -> None:
        """Join the per-crank delivery run; the first frame of a run arms
        ONE posted action that delivers everything pending at once."""
        self._pending_out.append(data)
        if not self._delivery_armed:
            self._delivery_armed = True
            self.overlay.clock.post_action(self._deliver_pending,
                                           name="loopback-delivery")

    def _deliver_pending(self) -> None:
        self._delivery_armed = False
        pending, self._pending_out = self._pending_out, []
        partner = self.partner
        if not pending or partner is None:
            return
        partner.data_received(
            pending[0] if len(pending) == 1 else b"".join(pending))

    def _flush_held(self) -> None:
        """Deliver a reorder-held frame that nothing has overtaken."""
        held, self._held_back = self._held_back, None
        if held is not None and self.partner is not None:
            self._enqueue_delivery(held)

    def _emit_batch(self, run: List[bytes]) -> None:
        """Fault-aware BATCHED_AUTH emission: with any fault probability
        set, the drop/damage/reorder draws happen PER CONTAINED MESSAGE in
        send order — the same conditional draw sequence (and therefore the
        same RNG stream consumption per message) as the unbatched
        per-frame path in _write_bytes, so a seeded campaign replays
        identically in either transport mode.

        Outcome mapping keeps unbatched fail-stop semantics:
        - drop: any dropped message loses the WHOLE frame (the sequence
          number still advances), so the receiver hits the same seq-gap
          fail-stop a dropped per-message frame causes — and P(link
          survives k messages) is (1-p)^k in both modes;
        - damage: the flip lands in that message's body bytes when the
          drawn offset maps there (same randrange span as a per-message
          frame), else in the frame MAC — either way the one-MAC check
          fails and the link fail-stops, like an unbatched damaged frame;
        - reorder: the held message lands behind its successor INSIDE the
          run.  This is the one intentional semantic delta: intra-batch
          reordering is benign (one frame, one sequence number), whereas
          reordered per-message frames break the sequence chain.  The
          frame bypasses _write_bytes so nothing double-draws."""
        if not (self.drop_probability or self.damage_probability
                or self.reorder_probability):
            super()._emit_batch(run)
            return
        rng = self.fault_rng
        entries = []   # (body, flip-or-None) in final intra-run order
        held = None
        any_dropped = False
        for body in run:
            if self.drop_probability \
                    and rng.random() < self.drop_probability:
                any_dropped = True
                if held is not None:
                    entries.append(held)
                    held = None
                continue
            flip = None
            if self.damage_probability \
                    and rng.random() < self.damage_probability:
                # same span a per-message frame would offer _write_bytes:
                # 4-byte record mark excluded, arm+seq+body+mac included
                flip = (rng.randrange(4, len(body) + 48), rng.randrange(8))
            if self.reorder_probability \
                    and rng.random() < self.reorder_probability \
                    and held is None:
                held = (body, flip)
                continue
            entries.append((body, flip))
            if held is not None:
                entries.append(held)
                held = None
        if held is not None:
            entries.append(held)
        # the sender MACs what it sent: build the valid frame first (the
        # sequence number advances and the batch metrics mark even for a
        # frame the link then loses, like any transport), then corrupt it
        # in transit
        if not entries:
            # every message dropped: burn the sequence number the frame
            # would have consumed so the seq-gap fail-stop still fires
            self._send_seq += 1
            return
        frame = self._build_batch_frame([body for body, _ in entries])
        if any_dropped or self.partner is None or self.drop_outbound:
            return
        buf = bytearray(frame)
        # frame layout: 4 record mark + 4 arm + 8 seq + 4 count, then per
        # body: 4-byte length + body; MAC is the trailing 32 bytes
        off = 20
        for body, flip in entries:
            off += 4
            if flip is not None:
                pos, bit = flip
                if 16 <= pos < 16 + len(body):
                    # maps into the message body: flip that exact byte
                    buf[off + (pos - 16)] ^= 1 << bit
                else:
                    # arm/seq/MAC region of a per-message frame: flip a
                    # frame-MAC byte — same MAC-failure fail-stop class
                    buf[len(buf) - 32 + (pos % 32)] ^= 1 << bit
            off += len(body)
        self._enqueue_delivery(bytes(buf))

    def _arm_backstop(self) -> None:
        """Flush a still-held frame after a grace round — frames posted
        later in the same crank get to overtake (that's the reorder), but
        a quiesced stream still delivers everything eventually.  Each hold
        gets its own generation so a stale backstop from an earlier hold
        cannot shorten the current frame's grace period."""
        self._backstop_gen += 1
        gen = self._backstop_gen

        def tick(rounds: int = 2) -> None:
            if self._held_back is None or self._backstop_gen != gen:
                return  # released by a later send, or superseded
            if rounds > 1:
                self.overlay.clock.post_action(
                    lambda: tick(rounds - 1), name="loopback-reorder-flush")
            else:
                self._flush_held()

        self.overlay.clock.post_action(tick, name="loopback-reorder-flush")

    def _close_transport(self) -> None:
        self._flush_held()
        if self.partner is not None and self.partner.state != Peer.CLOSING:
            partner, self.partner = self.partner, None
            partner.partner = None
            partner.drop("partner closed")


def make_loopback_pair(overlay_a, overlay_b, fault_rng=None):
    """Wire two overlays with a loopback connection; a dials b.

    ``fault_rng`` (a seeded ``random.Random``) is shared by both
    directions of the link: every damage/drop/reorder decision on the
    pair draws from one deterministic stream, so a simulation that logs
    its seed can replay the exact same fault sequence."""
    pa = LoopbackPeer(overlay_a, we_called_remote=True, fault_rng=fault_rng)
    pb = LoopbackPeer(overlay_b, we_called_remote=False, fault_rng=fault_rng)
    pa.partner, pb.partner = pb, pa
    overlay_a._register_peer(pa)
    overlay_b._register_peer(pb)
    pb.connect_handler()
    pa.connect_handler()
    return pa, pb
