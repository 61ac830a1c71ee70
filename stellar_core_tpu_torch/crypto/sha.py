"""Hashing primitives. Reference: src/crypto/SHA.{h,cpp} — sha256, SHA256 (streaming);
src/crypto/ShortHash.h — shortHash (SipHash-2-4, used for cache keys/hints)."""

from __future__ import annotations

import hashlib
import hmac as _hmac
import struct


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


class SHA256:
    """Streaming SHA-256 (reference: src/crypto/SHA.h — class SHA256)."""

    def __init__(self) -> None:
        self._h = hashlib.sha256()

    def add(self, data: bytes) -> "SHA256":
        self._h.update(data)
        return self

    def finish(self) -> bytes:
        return self._h.digest()


def hmac_sha256(key: bytes, data: bytes) -> bytes:
    return _hmac.new(key, data, hashlib.sha256).digest()


def hmac_sha256_verify(key: bytes, data: bytes, mac: bytes) -> bool:
    return _hmac.compare_digest(hmac_sha256(key, data), mac)


def hkdf_extract(key: bytes) -> bytes:
    """Reference overlay key derivation (src/crypto/ECDH.cpp — hkdfExtract):
    HMAC with a zero salt."""
    return hmac_sha256(b"\x00" * 32, key)


def hkdf_expand(key: bytes, info: bytes) -> bytes:
    return hmac_sha256(key, info + b"\x01")


def _sipround(v0: int, v1: int, v2: int, v3: int) -> tuple[int, int, int, int]:
    M = 0xFFFFFFFFFFFFFFFF
    v0 = (v0 + v1) & M
    v1 = ((v1 << 13) | (v1 >> 51)) & M
    v1 ^= v0
    v0 = ((v0 << 32) | (v0 >> 32)) & M
    v2 = (v2 + v3) & M
    v3 = ((v3 << 16) | (v3 >> 48)) & M
    v3 ^= v2
    v0 = (v0 + v3) & M
    v3 = ((v3 << 21) | (v3 >> 43)) & M
    v3 ^= v0
    v2 = (v2 + v1) & M
    v1 = ((v1 << 17) | (v1 >> 47)) & M
    v1 ^= v2
    v2 = ((v2 << 32) | (v2 >> 32)) & M
    return v0, v1, v2, v3


def siphash24(key: bytes, data: bytes) -> int:
    """SipHash-2-4 → uint64 (reference: lib/siphash, src/crypto/ShortHash.cpp)."""
    assert len(key) == 16
    k0, k1 = struct.unpack("<QQ", key)
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573
    b = len(data) & 0xFF
    i = 0
    while i + 8 <= len(data):
        (m,) = struct.unpack_from("<Q", data, i)
        v3 ^= m
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m
        i += 8
    tail = data[i:] + b"\x00" * (8 - len(data[i:]))
    (m,) = struct.unpack("<Q", tail[:8])
    m = (m & ((1 << 56) - 1)) | (b << 56)
    v3 ^= m
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 ^= m
    v2 ^= 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3
