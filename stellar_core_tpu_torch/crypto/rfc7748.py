"""Pure-Python X25519 (RFC 7748 section 5), for machines where libsodium
does not load.

``scalarmult`` makes libsodium's ``crypto_scalarmult_curve25519`` bytes
and refusals: the scalar is clamped, the top bit of u is masked and u is
taken mod p, the Montgomery ladder runs over all 255 bits, and the result
is the canonical u of [k]P.  Like libsodium it refuses a u on its
small-order blocklist (the top bit masked) and an all-zero result, both
raising ``LowOrderPoint``.  ``scalarmult_base`` is [k]9, as
``crypto_scalarmult_curve25519_base`` computes it.  crypto/sodium.py falls
back to these functions where libsodium does not load.  Slow (python
ints): a handshake's few multiplies, never a batch.
"""

from __future__ import annotations

P = 2 ** 255 - 19
A24 = 121665
BASE_U = 9


class LowOrderPoint(ValueError):
    """u is of small order, or the product is all zero."""


# libsodium's has_small_order blocklist (crypto_scalarmult/curve25519/
# ref10/x25519_ref10.c): 0, 1, the two points of order 8, p - 1, p and
# p + 1, compared with the top bit of u masked
_BLOCKLIST = frozenset(
    [0, 1,
     0x00b8495f16056286fdb1329ceb8d09da6ac49ff1fae35616aeb8413b7c7aebe0,
     0x57119fd0dd4e22d8868e1c58c45c44045bef839c55b1d0b1248c50a3bc959c5f,
     P - 1, P, P + 1])


def _clamp(k: bytes) -> int:
    n = bytearray(k)
    n[0] &= 248
    n[31] &= 127
    n[31] |= 64
    return int.from_bytes(n, "little")


def _ladder(k: int, u: int) -> int:
    """u of [k](u, .) by RFC 7748's constant-shape ladder (python ints)."""
    x1 = u % P
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        bit = (k >> t) & 1
        if swap ^ bit:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a, b = x2 + z2, x2 - z2
        aa, bb = a * a % P, b * b % P
        e = aa - bb
        c, d = x3 + z3, x3 - z3
        da, cb = d * a % P, c * b % P
        x3 = (da + cb) ** 2 % P
        z3 = x1 * (da - cb) ** 2 % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, P - 2, P) % P


def scalarmult(k: bytes, u: bytes) -> bytes:
    """X25519(k, u): 32 bytes, or LowOrderPoint as libsodium refuses."""
    if len(k) != 32 or len(u) != 32:
        raise ValueError("X25519 takes a 32-byte scalar and a 32-byte u")
    u_int = int.from_bytes(u, "little") & ((1 << 255) - 1)
    if u_int in _BLOCKLIST:
        raise LowOrderPoint("u is of small order")
    out = _ladder(_clamp(k), u_int)
    if out == 0:
        raise LowOrderPoint("the shared secret is all zero")
    return out.to_bytes(32, "little")


def scalarmult_base(k: bytes) -> bytes:
    """X25519(k, 9): the public key of the secret k."""
    if len(k) != 32:
        raise ValueError("X25519 takes a 32-byte scalar")
    return _ladder(_clamp(k), BASE_U).to_bytes(32, "little")
