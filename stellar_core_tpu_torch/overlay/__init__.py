"""P2P overlay layer (reference: src/overlay/)."""

from .flood import Floodgate, ItemFetcher, TxAdverts
from .overlay_manager import OverlayManager
from .peer import (FrameDecoder, LoopbackPeer, Peer, frame_encode,
                   make_loopback_pair)
from .peer_auth import PeerAuth, mac_message, mac_ok
from .tcp import TCPPeer, TCPTransport

__all__ = [
    "Floodgate", "FrameDecoder", "ItemFetcher", "LoopbackPeer",
    "OverlayManager", "Peer", "PeerAuth", "TCPPeer", "TCPTransport",
    "TxAdverts", "frame_encode", "mac_message", "mac_ok",
    "make_loopback_pair",
]
