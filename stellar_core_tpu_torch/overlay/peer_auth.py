"""Peer authentication: Curve25519 ECDH -> per-direction HMAC-SHA256 keys.

Reference: src/overlay/PeerAuth.{h,cpp} + PeerSharedKeyId — each node holds
an ephemeral Curve25519 keypair whose public half is certified by the
node's Ed25519 identity key inside an expiring AuthCert carried in HELLO;
the ECDH shared secret plus both HELLO nonces derive one HMAC key per
direction, and every post-HELLO message carries (sequence, mac) verified
with a strictly increasing counter (src/overlay/Peer.cpp recvAuthenticated
checks).

The derivation is HKDF-style (extract with a zero salt, expand with a
direction label).  It is self-consistent for this framework's networks;
byte-compatibility with the C++ implementation's HKDF labels is a non-goal
(the networks are disjoint), the *shape* of the protocol is kept.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from typing import Optional, Tuple

from .. import xdr as X
from ..crypto import sodium
from ..crypto.keys import PublicKey, SecretKey, verify_sig
from ..crypto.sha import sha256

AUTH_CERT_LIFETIME = 60 * 60  # seconds (reference: one hour)

_CERT_PREFIX = b"stellar-core-tpu auth cert"


def _cert_payload(network_id: bytes, expiration: int, pubkey: bytes) -> bytes:
    return sha256(network_id + _CERT_PREFIX
                  + expiration.to_bytes(8, "big") + pubkey)


class PeerAuth:
    """Holds this node's auth keypair and mints/validates certs."""

    def __init__(self, node_secret: SecretKey, network_id: bytes,
                 now_fn, auth_seed: Optional[bytes] = None):
        self.node_secret = node_secret
        self.network_id = network_id
        self.now_fn = now_fn
        seed = auth_seed if auth_seed is not None else os.urandom(32)
        # clamped Curve25519 secret
        sec = bytearray(sha256(seed))
        sec[0] &= 248
        sec[31] &= 127
        sec[31] |= 64
        self.auth_secret = bytes(sec)
        self.auth_public = sodium.scalarmult_curve25519_base(self.auth_secret)
        self._cert: Optional[X.AuthCert] = None

    def get_cert(self) -> X.AuthCert:
        now = int(self.now_fn())
        if self._cert is None or self._cert.expiration <= now + 60:
            expiration = now + AUTH_CERT_LIFETIME
            payload = _cert_payload(self.network_id, expiration,
                                    self.auth_public)
            self._cert = X.AuthCert(
                pubkey=X.Curve25519Public(key=self.auth_public),
                expiration=expiration,
                sig=self.node_secret.sign(payload))
        return self._cert

    def verify_remote_cert(self, cert: X.AuthCert,
                           peer_id: bytes) -> bool:
        """peer_id: the claimed Ed25519 node id from HELLO."""
        if cert.expiration < int(self.now_fn()):
            return False
        payload = _cert_payload(self.network_id, cert.expiration,
                                cert.pubkey.key)
        return verify_sig(PublicKey(peer_id), cert.sig, payload)

    def shared_keys(self, remote_pub: bytes, local_nonce: bytes,
                    remote_nonce: bytes, we_called: bool
                    ) -> Tuple[bytes, bytes]:
        """(sending_key, receiving_key) for this side of the session."""
        shared = sodium.scalarmult_curve25519(self.auth_secret, remote_pub)
        if we_called:
            pubs = self.auth_public + remote_pub
            nonces = local_nonce + remote_nonce
        else:
            pubs = remote_pub + self.auth_public
            nonces = remote_nonce + local_nonce
        prk = hmac.new(b"\x00" * 32, shared + pubs + nonces,
                       hashlib.sha256).digest()
        caller_to_acceptor = hmac.new(prk, b"caller->acceptor\x01",
                                      hashlib.sha256).digest()
        acceptor_to_caller = hmac.new(prk, b"acceptor->caller\x02",
                                      hashlib.sha256).digest()
        if we_called:
            return caller_to_acceptor, acceptor_to_caller
        return acceptor_to_caller, caller_to_acceptor


def mac_message(key: bytes, sequence: int, message_xdr: bytes) -> bytes:
    return hmac.new(key, sequence.to_bytes(8, "big") + message_xdr,
                    hashlib.sha256).digest()


def mac_ok(key: bytes, sequence: int, message_xdr: bytes,
           mac: bytes) -> bool:
    return hmac.compare_digest(mac_message(key, sequence, message_xdr), mac)
