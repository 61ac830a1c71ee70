"""Pure-Python Ed25519 (RFC 8032 section 5.1): key generation, signing
and verification, for machines where libsodium does not load.

Deterministic signing makes the same bytes as libsodium's
``crypto_sign_seed_keypair`` and ``crypto_sign_detached`` (the tests hold
them byte for byte).  ``verify`` applies libsodium's acceptance rules of
``crypto_sign_verify_detached``, not the RFC's: S < L, a canonical A, R and
A off the small-order blocklist, and R' = [S]B - [h]A equal to R byte for
byte.  Keys take libsodium's forms (the secret key is the seed, then
the public key).  crypto/sodium.py falls back to these functions where
libsodium does not load.  Slow (python ints), never on the verify path.
"""

from __future__ import annotations

import hashlib

from ..accel.curve import BX, BY, D, D2, P, SQRT_M1
from ..accel.ed25519 import L


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


def _mult(k: int, pt):
    """[k]pt by double-and-add (the add formula is complete: it doubles)."""
    acc = (0, 1, 1, 0)
    while k:
        if k & 1:
            acc = _pt_add(acc, pt)
        pt = _pt_add(pt, pt)
        k >>= 1
    return acc


def _expand(seed: bytes):
    """(clamped scalar, prefix) of a 32-byte seed (RFC 8032 5.1.5)."""
    d = hashlib.sha512(seed).digest()
    a = int.from_bytes(d[:32], "little")
    return (a & ((1 << 254) - 8)) | (1 << 254), d[32:]


def keypair(seed: bytes):
    """(pk, sk) from a 32-byte seed, as crypto_sign_seed_keypair."""
    pk = _encode(_base_mult(_expand(seed)[0]))
    return pk, seed + pk


def sign(msg: bytes, sk: bytes) -> bytes:
    """The 64-byte signature of msg under a 64-byte secret key, as
    crypto_sign_detached."""
    (a, prefix), pk = _expand(sk[:32]), sk[32:]
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    big_r = _encode(_base_mult(r))
    h = int.from_bytes(hashlib.sha512(big_r + pk + msg).digest(), "little") % L
    return big_r + ((r + h * a) % L).to_bytes(32, "little")


# libsodium's small-order blocklist (ge25519_has_small_order): the y of
# the points of order 1, 2, 4 and 8, and p, p + 1 (0 and 1 again, not
# reduced); an encoding matches whatever its sign bit
_SMALL_ORDER_Y = frozenset((
    0, 1,
    0x05fc536d880238b13933c6d305acdfd5f098eff289f4c345b027b2c28f95e826,
    0x7a03ac9277fdc74ec6cc392cfa53202a0f67100d760b3cba4fd84d3d706a17c7,
    P - 1, P, P + 1))
_Y_MASK = (1 << 255) - 1


def _decode(enc: bytes):
    """The point of a canonical encoding, or None where y has no x
    (ge25519_frombytes: unlike RFC 8032, x = 0 with the sign bit set is
    not refused; its two points are on the blocklist)."""
    y = int.from_bytes(enc, "little") & _Y_MASK
    u, v = (y * y - 1) % P, (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    if (v * x * x - u) % P:
        if (v * x * x + u) % P:
            return None
        x = x * SQRT_M1 % P
    if (x & 1) != enc[31] >> 7:
        x = (P - x) % P
    return (x, y, 1, x * y % P)


def verify(sig: bytes, msg: bytes, pk: bytes) -> bool:
    """crypto_sign_verify_detached's verdict, in python ints."""
    if len(sig) != 64 or len(pk) != 32:
        return False
    if int.from_bytes(sig[32:], "little") >= L:
        return False                                    # S not canonical
    if int.from_bytes(sig[:32], "little") & _Y_MASK in _SMALL_ORDER_Y:
        return False                                    # R of small order
    y = int.from_bytes(pk, "little") & _Y_MASK
    if y >= P or y in _SMALL_ORDER_Y:
        return False                                    # A not canonical / small
    a = _decode(pk)
    if a is None:
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                       "little") % L
    neg_a = ((P - a[0]) % P, a[1], 1, (P - a[3]) % P)
    r = _pt_add(_base_mult(int.from_bytes(sig[32:], "little")),
                _mult(h, neg_a))
    return _encode(r) == sig[:32]
