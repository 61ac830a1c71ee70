"""Stellar-overlay.x equivalents (reference: src/protocol-curr/xdr/
Stellar-overlay.x) — the P2P wire protocol: HELLO/AUTH handshake types,
flood adverts/demands, item fetch, flow control and the authenticated
message envelope."""

from .codec import (Int32, Opaque, Uint32, Uint64, VarArray, VarOpaque,
                    XdrString, xdr_enum, xdr_struct, xdr_union)
from .types import Hash, NodeID, Signature, Uint256

ErrorCode = xdr_enum("ErrorCode", {
    "ERR_MISC": 0,
    "ERR_DATA": 1,
    "ERR_CONF": 2,
    "ERR_AUTH": 3,
    "ERR_LOAD": 4,
})

Error = xdr_struct("Error", [
    ("code", ErrorCode),
    ("msg", XdrString(100)),
])

Curve25519Public = xdr_struct("Curve25519Public", [
    ("key", Opaque(32)),
])

HmacSha256Mac = xdr_struct("HmacSha256Mac", [
    ("mac", Opaque(32)),
])

AuthCert = xdr_struct("AuthCert", [
    ("pubkey", Curve25519Public),
    ("expiration", Uint64),
    ("sig", Signature),
])

Hello = xdr_struct("Hello", [
    ("ledgerVersion", Uint32),
    ("overlayVersion", Uint32),
    ("overlayMinVersion", Uint32),
    ("networkID", Hash),
    ("versionStr", XdrString(100)),
    ("listeningPort", Int32),
    ("peerID", NodeID),
    ("cert", AuthCert),
    ("nonce", Uint256),
])

# AUTH_MSG_FLAG_FLOW_CONTROL_BYTES_REQUESTED = 200 in the reference; we
# always speak flow control so the flag is informational.
# AUTH_FLAG_BATCH is an extension bit of this implementation: a node that sets it in its own
# AUTH accepts (and, if the remote also set it, emits) BATCHED_AUTH
# frames — AuthenticatedMessage arm 1 below.  Peers that never sent the
# flag never see arm-1 frames, so flags=0 links stay byte-compatible
# with the per-message wire format.
AUTH_FLAG_BATCH = 1

Auth = xdr_struct("Auth", [
    ("flags", Int32),
], defaults={"flags": 0})

IPAddrType = xdr_enum("IPAddrType", {"IPv4": 0, "IPv6": 1})

PeerAddressIp = xdr_union("PeerAddressIp", IPAddrType, {
    IPAddrType.IPv4: ("ipv4", Opaque(4)),
    IPAddrType.IPv6: ("ipv6", Opaque(16)),
})

PeerAddress = xdr_struct("PeerAddress", [
    ("ip", PeerAddressIp),
    ("port", Uint32),
    ("numFailures", Uint32),
], defaults={"numFailures": 0})

MessageType = xdr_enum("MessageType", {
    "ERROR_MSG": 0,
    "AUTH": 2,
    "DONT_HAVE": 3,
    "GET_PEERS": 4,
    "PEERS": 5,
    "GET_TX_SET": 6,
    "TX_SET": 7,
    "TRANSACTION": 8,
    "GET_SCP_QUORUMSET": 9,
    "SCP_QUORUMSET": 10,
    "SCP_MESSAGE": 11,
    "GET_SCP_STATE": 12,
    "HELLO": 13,
    "SEND_MORE": 16,
    "GENERALIZED_TX_SET": 17,
    "FLOOD_ADVERT": 18,
    "FLOOD_DEMAND": 19,
    "SEND_MORE_EXTENDED": 20,
    "TIME_SLICED_SURVEY_REQUEST": 21,
    "TIME_SLICED_SURVEY_RESPONSE": 22,
    "TIME_SLICED_SURVEY_START_COLLECTING": 23,
    "TIME_SLICED_SURVEY_STOP_COLLECTING": 24,
})

DontHave = xdr_struct("DontHave", [
    ("type", MessageType),
    ("reqHash", Uint256),
])

SendMore = xdr_struct("SendMore", [
    ("numMessages", Uint32),
])

SendMoreExtended = xdr_struct("SendMoreExtended", [
    ("numMessages", Uint32),
    ("numBytes", Uint32),
])

TX_ADVERT_VECTOR_MAX_SIZE = 1000
TX_DEMAND_VECTOR_MAX_SIZE = 1000

FloodAdvert = xdr_struct("FloodAdvert", [
    ("txHashes", VarArray(Hash, TX_ADVERT_VECTOR_MAX_SIZE)),
])

FloodDemand = xdr_struct("FloodDemand", [
    ("txHashes", VarArray(Hash, TX_DEMAND_VECTOR_MAX_SIZE)),
])


# -- time-sliced network survey (reference: Stellar-overlay.x survey types +
# src/overlay/SurveyManager) -------------------------------------------------

SurveyMessageCommandType = xdr_enum("SurveyMessageCommandType", {
    "TIME_SLICED_SURVEY_TOPOLOGY": 1,
})

SurveyMessageResponseType = xdr_enum("SurveyMessageResponseType", {
    "SURVEY_TOPOLOGY_RESPONSE_V2": 2,
})

SurveyRequestMessage = xdr_struct("SurveyRequestMessage", [
    ("surveyorPeerID", NodeID),
    ("surveyedPeerID", NodeID),
    ("ledgerNum", Uint32),
    ("encryptionKey", Curve25519Public),
    ("commandType", SurveyMessageCommandType),
], defaults={"commandType":
             SurveyMessageCommandType.TIME_SLICED_SURVEY_TOPOLOGY})

TimeSlicedSurveyRequestMessage = xdr_struct("TimeSlicedSurveyRequestMessage", [
    ("request", SurveyRequestMessage),
    ("nonce", Uint32),
    ("inboundPeersIndex", Uint32),
    ("outboundPeersIndex", Uint32),
], defaults={"inboundPeersIndex": 0, "outboundPeersIndex": 0})

SignedTimeSlicedSurveyRequestMessage = xdr_struct(
    "SignedTimeSlicedSurveyRequestMessage", [
        ("requestSignature", Signature),
        ("request", TimeSlicedSurveyRequestMessage),
    ])

EncryptedBody = VarOpaque(64000)

SurveyResponseMessage = xdr_struct("SurveyResponseMessage", [
    ("surveyorPeerID", NodeID),
    ("surveyedPeerID", NodeID),
    ("ledgerNum", Uint32),
    ("commandType", SurveyMessageCommandType),
    ("encryptedBody", EncryptedBody),
], defaults={"commandType":
             SurveyMessageCommandType.TIME_SLICED_SURVEY_TOPOLOGY})

TimeSlicedSurveyResponseMessage = xdr_struct(
    "TimeSlicedSurveyResponseMessage", [
        ("response", SurveyResponseMessage),
        ("nonce", Uint32),
    ])

SignedTimeSlicedSurveyResponseMessage = xdr_struct(
    "SignedTimeSlicedSurveyResponseMessage", [
        ("responseSignature", Signature),
        ("response", TimeSlicedSurveyResponseMessage),
    ])

TimeSlicedSurveyStartCollectingMessage = xdr_struct(
    "TimeSlicedSurveyStartCollectingMessage", [
        ("surveyorID", NodeID),
        ("nonce", Uint32),
        ("ledgerNum", Uint32),
    ])

SignedTimeSlicedSurveyStartCollectingMessage = xdr_struct(
    "SignedTimeSlicedSurveyStartCollectingMessage", [
        ("signature", Signature),
        ("startCollecting", TimeSlicedSurveyStartCollectingMessage),
    ])

TimeSlicedSurveyStopCollectingMessage = xdr_struct(
    "TimeSlicedSurveyStopCollectingMessage", [
        ("surveyorID", NodeID),
        ("nonce", Uint32),
        ("ledgerNum", Uint32),
    ])

SignedTimeSlicedSurveyStopCollectingMessage = xdr_struct(
    "SignedTimeSlicedSurveyStopCollectingMessage", [
        ("signature", Signature),
        ("stopCollecting", TimeSlicedSurveyStopCollectingMessage),
    ])

PeerStats = xdr_struct("PeerStats", [
    ("id", NodeID),
    ("versionStr", XdrString(100)),
    ("messagesRead", Uint64),
    ("messagesWritten", Uint64),
    ("bytesRead", Uint64),
    ("bytesWritten", Uint64),
    ("secondsConnected", Uint64),
    ("uniqueFloodBytesRecv", Uint64),
    ("duplicateFloodBytesRecv", Uint64),
    ("uniqueFetchBytesRecv", Uint64),
    ("duplicateFetchBytesRecv", Uint64),
    ("uniqueFloodMessageRecv", Uint64),
    ("duplicateFloodMessageRecv", Uint64),
    ("uniqueFetchMessageRecv", Uint64),
    ("duplicateFetchMessageRecv", Uint64),
], defaults={k: 0 for k in (
    "messagesRead", "messagesWritten", "bytesRead", "bytesWritten",
    "secondsConnected", "uniqueFloodBytesRecv", "duplicateFloodBytesRecv",
    "uniqueFetchBytesRecv", "duplicateFetchBytesRecv",
    "uniqueFloodMessageRecv", "duplicateFloodMessageRecv",
    "uniqueFetchMessageRecv", "duplicateFetchMessageRecv")})

TimeSlicedPeerData = xdr_struct("TimeSlicedPeerData", [
    ("peerStats", PeerStats),
    ("averageLatencyMs", Uint32),
], defaults={"averageLatencyMs": 0})

TimeSlicedNodeData = xdr_struct("TimeSlicedNodeData", [
    ("addedAuthenticatedPeers", Uint32),
    ("droppedAuthenticatedPeers", Uint32),
    ("totalInboundPeerCount", Uint32),
    ("totalOutboundPeerCount", Uint32),
    ("p75SCPFirstToSelfLatencyMs", Uint32),
    ("p75SCPSelfToOtherLatencyMs", Uint32),
    ("lostSyncCount", Uint32),
    ("isValidator", Uint32),
    ("maxInboundPeerCount", Uint32),
    ("maxOutboundPeerCount", Uint32),
], defaults={k: 0 for k in (
    "addedAuthenticatedPeers", "droppedAuthenticatedPeers",
    "totalInboundPeerCount", "totalOutboundPeerCount",
    "p75SCPFirstToSelfLatencyMs", "p75SCPSelfToOtherLatencyMs",
    "lostSyncCount", "isValidator", "maxInboundPeerCount",
    "maxOutboundPeerCount")})

TopologyResponseBodyV2 = xdr_struct("TopologyResponseBodyV2", [
    ("inboundPeers", VarArray(TimeSlicedPeerData, 25)),
    ("outboundPeers", VarArray(TimeSlicedPeerData, 25)),
    ("nodeData", TimeSlicedNodeData),
])

SurveyResponseBody = xdr_union("SurveyResponseBody", SurveyMessageResponseType, {
    SurveyMessageResponseType.SURVEY_TOPOLOGY_RESPONSE_V2:
        ("topologyResponseBodyV2", TopologyResponseBodyV2),
})


def _build_stellar_message():
    # deferred imports dodge a cycle: transaction.py imports nothing from
    # here, but xdr/__init__ imports both
    from .scp import SCPEnvelope, SCPQuorumSet
    from .transaction import TransactionEnvelope
    from .ledger import GeneralizedTransactionSet, TransactionSet

    return xdr_union("StellarMessage", MessageType, {
        MessageType.ERROR_MSG: ("error", Error),
        MessageType.HELLO: ("hello", Hello),
        MessageType.AUTH: ("auth", Auth),
        MessageType.DONT_HAVE: ("dontHave", DontHave),
        MessageType.GET_PEERS: ("getPeers", None),
        MessageType.PEERS: ("peers", VarArray(PeerAddress, 100)),
        MessageType.GET_TX_SET: ("txSetHash", Uint256),
        MessageType.TX_SET: ("txSet", TransactionSet),
        MessageType.GENERALIZED_TX_SET:
            ("generalizedTxSet", GeneralizedTransactionSet),
        MessageType.TRANSACTION: ("transaction", TransactionEnvelope),
        MessageType.GET_SCP_QUORUMSET: ("qSetHash", Uint256),
        MessageType.SCP_QUORUMSET: ("qSet", SCPQuorumSet),
        MessageType.SCP_MESSAGE: ("envelope", SCPEnvelope),
        MessageType.GET_SCP_STATE: ("getSCPLedgerSeq", Uint32),
        MessageType.SEND_MORE: ("sendMoreMessage", SendMore),
        MessageType.SEND_MORE_EXTENDED: ("sendMoreExtendedMessage",
                                         SendMoreExtended),
        MessageType.FLOOD_ADVERT: ("floodAdvert", FloodAdvert),
        MessageType.FLOOD_DEMAND: ("floodDemand", FloodDemand),
        MessageType.TIME_SLICED_SURVEY_REQUEST:
            ("signedTimeSlicedSurveyRequestMessage",
             SignedTimeSlicedSurveyRequestMessage),
        MessageType.TIME_SLICED_SURVEY_RESPONSE:
            ("signedTimeSlicedSurveyResponseMessage",
             SignedTimeSlicedSurveyResponseMessage),
        MessageType.TIME_SLICED_SURVEY_START_COLLECTING:
            ("signedTimeSlicedSurveyStartCollectingMessage",
             SignedTimeSlicedSurveyStartCollectingMessage),
        MessageType.TIME_SLICED_SURVEY_STOP_COLLECTING:
            ("signedTimeSlicedSurveyStopCollectingMessage",
             SignedTimeSlicedSurveyStopCollectingMessage),
    })


StellarMessage = _build_stellar_message()

AuthenticatedMessageV0 = xdr_struct("AuthenticatedMessageV0", [
    ("sequence", Uint64),
    ("message", StellarMessage),
    ("mac", HmacSha256Mac),
])

# BATCHED_AUTH (an extension of this implementation, negotiated via AUTH_FLAG_BATCH): one
# sequence number + one MAC authenticate a packed run of StellarMessage
# encodings.  Each element of `messages` is one message's own XDR bytes
# (already 4-aligned, so the var-opaque padding is empty and the wire
# layout is exactly count + N x (u32 length + body)); the MAC covers
# everything between the sequence and the MAC itself.  The overlay
# splices these frames from pre-encoded bodies (overlay/peer.py) — this
# codec type exists for layout tests and debugging tools.
BATCH_WIRE_MAX_MESSAGES = 4096

BatchedAuthenticatedMessage = xdr_struct("BatchedAuthenticatedMessage", [
    ("sequence", Uint64),
    ("messages", VarArray(VarOpaque(0x7FFFFFFF), BATCH_WIRE_MAX_MESSAGES)),
    ("mac", HmacSha256Mac),
])

AuthenticatedMessage = xdr_union("AuthenticatedMessage", Uint32, {
    0: ("v0", AuthenticatedMessageV0),
    1: ("batch", BatchedAuthenticatedMessage),
})
