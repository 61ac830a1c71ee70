"""ctypes binding to the system libsodium: the verdict oracle.

Counterpart of stellar_core_tpu/crypto/sodium.py, reduced to what the port
needs: signing to make inputs and ``crypto_sign_verify_detached`` as the
verdict of record.  It is used only by the tests and chip_smoke.py, never on
the device path.  The library may be missing (the machine with the card need
not have it): ``available()`` then says False and every call raises, so a
caller reports the missing oracle instead of failing on import.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

_SONAMES = ("libsodium.so.23", "libsodium.so", "libsodium.dylib")

SIGN_BYTES = 64
SIGN_PUBLICKEYBYTES = 32
SIGN_SECRETKEYBYTES = 64
SIGN_SEEDBYTES = 32


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


def available() -> bool:
    return _lib is not None


def _require() -> ctypes.CDLL:
    if _lib is None:
        raise RuntimeError("libsodium is not installed on this machine")
    return _lib


def sign_seed_keypair(seed: bytes) -> Tuple[bytes, bytes]:
    """(public_key 32B, secret_key 64B) from a 32-byte seed."""
    if len(seed) != SIGN_SEEDBYTES:
        raise ValueError("seed must be 32 bytes")
    lib = _require()
    pk = ctypes.create_string_buffer(SIGN_PUBLICKEYBYTES)
    sk = ctypes.create_string_buffer(SIGN_SECRETKEYBYTES)
    if lib.crypto_sign_seed_keypair(pk, sk, seed) != 0:
        raise RuntimeError("crypto_sign_seed_keypair failed")
    return pk.raw, sk.raw


def sign_detached(msg: bytes, sk: bytes) -> bytes:
    """64-byte Ed25519 signature of msg under a 64-byte secret key."""
    if len(sk) != SIGN_SECRETKEYBYTES:
        raise ValueError("secret key must be 64 bytes")
    lib = _require()
    sig = ctypes.create_string_buffer(SIGN_BYTES)
    siglen = ctypes.c_ulonglong(0)
    if lib.crypto_sign_detached(sig, ctypes.byref(siglen), msg, len(msg), sk) != 0:
        raise RuntimeError("crypto_sign_detached failed")
    return sig.raw


def verify_detached(sig: bytes, msg: bytes, pk: bytes) -> bool:
    """libsodium's Ed25519 verdict (the oracle)."""
    if len(sig) != SIGN_BYTES or len(pk) != SIGN_PUBLICKEYBYTES:
        return False
    return _require().crypto_sign_verify_detached(sig, msg, len(msg), pk) == 0
