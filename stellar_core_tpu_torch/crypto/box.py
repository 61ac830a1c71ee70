"""Curve25519 sealed boxes for survey-response encryption.

Reference: src/overlay/SurveyManager uses libsodium ``crypto_box_seal`` —
an anonymous-sender ECIES over Curve25519 — so only the surveyor (holder of
the ephemeral Curve25519 secret in the request) can read a survey response.

This environment has libsodium at runtime but without headers, and the
framework only declares a handful of prototypes (SURVEY.md §7), so the seal
is composed from the primitives already wrapped: X25519 ECDH
(``crypto_scalarmult_curve25519``) + an HMAC-SHA256 keystream and tag.
Same security shape (ephemeral-static DH, key-committing MAC), not
byte-compatible with libsodium's box — both ends of a survey run this
framework, so wire compatibility is internal.

Layout: ``eph_pk(32) || tag(32) || ciphertext``.
"""

from __future__ import annotations

import hmac
import os
from hashlib import sha256 as _sha256

from . import sodium


def keypair(seed: bytes = None) -> tuple:
    """(public, secret) Curve25519 keypair; random unless seeded."""
    sk = bytearray(seed if seed is not None else os.urandom(32))
    # standard X25519 clamping
    sk[0] &= 248
    sk[31] &= 127
    sk[31] |= 64
    sk = bytes(sk)
    return sodium.scalarmult_curve25519_base(sk), sk


def _keystream(key: bytes, n: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < n:
        out += hmac.new(key, b"stream%d" % counter, _sha256).digest()
        counter += 1
    return bytes(out[:n])


def _derive(shared: bytes, eph_pk: bytes, recip_pk: bytes) -> tuple:
    base = _sha256(b"scb-seal" + shared + eph_pk + recip_pk).digest()
    enc_key = _sha256(base + b"enc").digest()
    mac_key = _sha256(base + b"mac").digest()
    return enc_key, mac_key


def seal(recipient_pk: bytes, plaintext: bytes) -> bytes:
    eph_pk, eph_sk = keypair()
    shared = sodium.scalarmult_curve25519(eph_sk, recipient_pk)
    enc_key, mac_key = _derive(shared, eph_pk, recipient_pk)
    ct = bytes(a ^ b for a, b in
               zip(plaintext, _keystream(enc_key, len(plaintext))))
    tag = hmac.new(mac_key, ct, _sha256).digest()
    return eph_pk + tag + ct


def seal_open(recipient_sk: bytes, blob: bytes) -> bytes:
    """Decrypt; raises ValueError on malformed input or MAC mismatch."""
    if len(blob) < 64:
        raise ValueError("sealed box too short")
    eph_pk, tag, ct = blob[:32], blob[32:64], blob[64:]
    recipient_pk = sodium.scalarmult_curve25519_base(recipient_sk)
    shared = sodium.scalarmult_curve25519(recipient_sk, eph_pk)
    enc_key, mac_key = _derive(shared, eph_pk, recipient_pk)
    if not hmac.compare_digest(tag, hmac.new(mac_key, ct, _sha256).digest()):
        raise ValueError("sealed box MAC mismatch")
    return bytes(a ^ b for a, b in zip(ct, _keystream(enc_key, len(ct))))
