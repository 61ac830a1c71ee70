"""ctypes binding to the system libsodium (runtime library only, no headers).

Reference seam: src/crypto/SecretKey.cpp — PubKeyUtils::verifySig wraps
libsodium ``crypto_sign_verify_detached``; SecretKey::sign wraps
``crypto_sign_detached``.  We declare the handful of prototypes we need
ourselves and load the versioned soname directly (``libsodium.so.23``).

All functions take/return ``bytes``; sizes are validated here so callers can
rely on hard guarantees.  This module is the CPU oracle that the card's batch
verifier (accel/ed25519.py) must match bit-for-bit.  Where libsodium does not
load (the machine with the card need not have it), signing, key generation and
verification fall back to the port's pure-Python crypto/rfc8032.py, whose
verify applies libsodium's acceptance rules; the scalarmult calls raise.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

_SONAMES = ("libsodium.so.23", "libsodium.so", "libsodium.dylib")


def _load() -> Optional[ctypes.CDLL]:
    for name in _SONAMES:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    found = ctypes.util.find_library("sodium")
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError:
            pass
    return None


_lib = _load()

SIGN_BYTES = 64
SIGN_PUBLICKEYBYTES = 32
SIGN_SECRETKEYBYTES = 64
SIGN_SEEDBYTES = 32
SCALARMULT_BYTES = 32

if _lib is not None:
    _lib.sodium_init.restype = ctypes.c_int
    _lib.sodium_init()

    _lib.crypto_sign_verify_detached.restype = ctypes.c_int
    _lib.crypto_sign_verify_detached.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_ulonglong, ctypes.c_char_p]
    _lib.crypto_sign_detached.restype = ctypes.c_int
    _lib.crypto_sign_detached.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ulonglong),
        ctypes.c_char_p, ctypes.c_ulonglong, ctypes.c_char_p]
    _lib.crypto_sign_seed_keypair.restype = ctypes.c_int
    _lib.crypto_sign_seed_keypair.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    _lib.crypto_scalarmult_curve25519.restype = ctypes.c_int
    _lib.crypto_scalarmult_curve25519.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    _lib.crypto_scalarmult_curve25519_base.restype = ctypes.c_int
    _lib.crypto_scalarmult_curve25519_base.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p]


def available() -> bool:
    return _lib is not None


def sign_seed_keypair(seed: bytes) -> Tuple[bytes, bytes]:
    """(public_key 32B, secret_key 64B) from a 32-byte seed."""
    if len(seed) != SIGN_SEEDBYTES:
        raise ValueError("seed must be 32 bytes")
    if _lib is None:
        return _fallback_seed_keypair(seed)
    pk = ctypes.create_string_buffer(SIGN_PUBLICKEYBYTES)
    sk = ctypes.create_string_buffer(SIGN_SECRETKEYBYTES)
    if _lib.crypto_sign_seed_keypair(pk, sk, seed) != 0:
        raise RuntimeError("crypto_sign_seed_keypair failed")
    return pk.raw, sk.raw


def sign_detached(msg: bytes, sk: bytes) -> bytes:
    """64-byte Ed25519 signature of msg under 64-byte secret key."""
    if len(sk) != SIGN_SECRETKEYBYTES:
        raise ValueError("secret key must be 64 bytes")
    if _lib is None:
        return _fallback_sign(msg, sk)
    sig = ctypes.create_string_buffer(SIGN_BYTES)
    siglen = ctypes.c_ulonglong(0)
    if _lib.crypto_sign_detached(sig, ctypes.byref(siglen), msg, len(msg), sk) != 0:
        raise RuntimeError("crypto_sign_detached failed")
    return sig.raw


def verify_detached(sig: bytes, msg: bytes, pk: bytes) -> bool:
    """libsodium-exact Ed25519 verification verdict (the CPU oracle)."""
    if len(sig) != SIGN_BYTES or len(pk) != SIGN_PUBLICKEYBYTES:
        return False
    if _lib is None:
        return _fallback_verify(sig, msg, pk)
    return _lib.crypto_sign_verify_detached(sig, msg, len(msg), pk) == 0


def scalarmult_curve25519_base(sk: bytes) -> bytes:
    if _lib is None:
        raise RuntimeError("libsodium unavailable")
    out = ctypes.create_string_buffer(SCALARMULT_BYTES)
    if _lib.crypto_scalarmult_curve25519_base(out, sk) != 0:
        raise RuntimeError("crypto_scalarmult_curve25519_base failed")
    return out.raw


def scalarmult_curve25519(sk: bytes, pk: bytes) -> bytes:
    if _lib is None:
        raise RuntimeError("libsodium unavailable")
    out = ctypes.create_string_buffer(SCALARMULT_BYTES)
    if _lib.crypto_scalarmult_curve25519(out, sk, pk) != 0:
        raise RuntimeError("crypto_scalarmult_curve25519 failed (low order?)")
    return out.raw


# ---------------------------------------------------------------------------
# Fallback path (no libsodium): the port's pure-Python RFC 8032 code.  Its
# signing makes libsodium's bytes and its verify applies libsodium's rules
# (S < L, canonical A, the small-order blocklist for R and A); libsodium is
# the verdict of record when present.
# ---------------------------------------------------------------------------

def _fallback_seed_keypair(seed: bytes) -> Tuple[bytes, bytes]:
    from . import rfc8032
    return rfc8032.keypair(seed)


def _fallback_sign(msg: bytes, sk: bytes) -> bytes:
    from . import rfc8032
    return rfc8032.sign(msg, sk)


def _fallback_verify(sig: bytes, msg: bytes, pk: bytes) -> bool:
    from . import rfc8032
    return rfc8032.verify(sig, msg, pk)
