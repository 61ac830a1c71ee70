"""StrKey: Stellar's human-readable key encoding.

Reference: src/crypto/StrKey.{h,cpp} — base32 (RFC 4648 alphabet, no padding
in the canonical form) over [version byte | payload | CRC16-XModem(LE)].

Version bytes (reference: src/crypto/StrKey.h — STRKEY_PUBKEY etc.):
  G = 6  << 3   ed25519 public key
  S = 18 << 3   ed25519 seed
  T = 19 << 3   pre-auth tx hash
  X = 23 << 3   sha256 hash-x signer
  M = 12 << 3   muxed account (ed25519 + 8-byte id)
  C = 2  << 3   contract id
"""

from __future__ import annotations

import base64
from enum import IntEnum


class StrKeyVersion(IntEnum):
    PUBKEY_ED25519 = 6 << 3        # 'G'
    SEED_ED25519 = 18 << 3         # 'S'
    PRE_AUTH_TX = 19 << 3          # 'T'
    HASH_X = 23 << 3               # 'X'
    MUXED_ED25519 = 12 << 3        # 'M'
    SIGNED_PAYLOAD = 15 << 3       # 'P'
    CONTRACT = 2 << 3              # 'C'


_PAYLOAD_LEN = {
    StrKeyVersion.PUBKEY_ED25519: (32,),
    StrKeyVersion.SEED_ED25519: (32,),
    StrKeyVersion.PRE_AUTH_TX: (32,),
    StrKeyVersion.HASH_X: (32,),
    StrKeyVersion.MUXED_ED25519: (40,),
    StrKeyVersion.CONTRACT: (32,),
    StrKeyVersion.SIGNED_PAYLOAD: tuple(range(32 + 4 + 4, 32 + 4 + 64 + 1)),
}


def crc16_xmodem(data: bytes) -> int:
    """CRC16/XMODEM (poly 0x1021, init 0): matches reference src/crypto/StrKey.cpp."""
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def encode(version: StrKeyVersion, payload: bytes) -> str:
    raw = bytes([version]) + payload
    crc = crc16_xmodem(raw)
    raw += bytes([crc & 0xFF, crc >> 8])  # little-endian checksum
    enc = base64.b32encode(raw).decode("ascii")
    return enc.rstrip("=")


def decode(version: StrKeyVersion, s: str) -> bytes:
    payload, got_version = decode_any(s)
    if got_version != version:
        raise ValueError(f"strkey version mismatch: want {version}, got {got_version}")
    return payload


def decode_any(s: str) -> tuple[bytes, StrKeyVersion]:
    if not s or s != s.upper():
        raise ValueError("strkey must be upper-case base32")
    # b32decode needs padding restored; canonical strkeys carry none.
    pad = (-len(s)) % 8
    if pad == 1 or pad == 3 or pad == 6:
        raise ValueError("invalid strkey length")
    try:
        raw = base64.b32decode(s + "=" * pad)
    except Exception as e:
        raise ValueError(f"invalid base32: {e}") from e
    if len(raw) < 3:
        raise ValueError("strkey too short")
    body, crc_bytes = raw[:-2], raw[-2:]
    crc = crc16_xmodem(body)
    if crc_bytes != bytes([crc & 0xFF, crc >> 8]):
        raise ValueError("strkey checksum mismatch")
    try:
        version = StrKeyVersion(body[0])
    except ValueError as e:
        raise ValueError(f"unknown strkey version byte {body[0]}") from e
    payload = body[1:]
    if len(payload) not in _PAYLOAD_LEN[version]:
        raise ValueError("bad strkey payload length")
    # Reject non-canonical encodings (trailing bits / over-padding), as the
    # reference does: re-encode must round-trip.
    if encode(version, payload) != s:
        raise ValueError("non-canonical strkey")
    return payload, version


def encode_seed(raw: bytes) -> str:
    return encode(StrKeyVersion.SEED_ED25519, raw)


