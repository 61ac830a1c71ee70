"""Pure-Python Ed25519 key generation and signing (RFC 8032 section 5.1.5
and 5.1.6), for making test inputs where libsodium is missing.

Deterministic signing makes the same bytes as libsodium's
``crypto_sign_seed_keypair`` and ``crypto_sign_detached`` (the tests hold
them byte for byte).  ``Signer`` picks libsodium where it loads, else this
signer; the port's graft entry and chip_smoke.py make their signatures
through it.  Slow (python ints), never on the verify path.
"""

from __future__ import annotations

import hashlib

from ..accel.curve import BX, BY, D2, P
from ..accel.ed25519 import L
from . import sodium


def _pt_add(p, q):
    """Extended-coordinate add (complete, a = -1) on python ints."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * t2 % P * D2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


_B_POW2 = []   # B * 2^i, i = 0..255, extended coordinates


def _base_mult(k: int):
    if not _B_POW2:
        pt = (BX, BY, 1, BX * BY % P)
        for _ in range(256):
            _B_POW2.append(pt)
            pt = _pt_add(pt, pt)
    acc = (0, 1, 1, 0)
    for i in range(k.bit_length()):
        if (k >> i) & 1:
            acc = _pt_add(acc, _B_POW2[i])
    return acc


def _encode(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def keypair(seed: bytes):
    """(pk, sk) from a 32-byte seed, as crypto_sign_seed_keypair; sk is
    this module's (scalar, prefix, pk), not libsodium's 64 bytes."""
    d = hashlib.sha512(seed).digest()
    a = int.from_bytes(d[:32], "little")
    a = (a & ((1 << 254) - 8)) | (1 << 254)
    pk = _encode(_base_mult(a))
    return pk, (a, d[32:], pk)


def sign(msg: bytes, sk) -> bytes:
    """The 64-byte signature of msg under a keypair() secret key."""
    a, prefix, pk = sk
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    big_r = _encode(_base_mult(r))
    h = int.from_bytes(hashlib.sha512(big_r + pk + msg).digest(), "little") % L
    return big_r + ((r + h * a) % L).to_bytes(32, "little")


class Signer:
    """libsodium where it loads, else the RFC 8032 signer above."""

    def __init__(self):
        self.name = "libsodium" if sodium.available() else "python-rfc8032"

    def keypair(self, seed: bytes):
        if sodium.available():
            return sodium.sign_seed_keypair(seed)
        return keypair(seed)

    def sign(self, msg: bytes, sk) -> bytes:
        if sodium.available():
            return sodium.sign_detached(msg, sk)
        return sign(msg, sk)
