"""Hashing primitives. Reference: src/crypto/SHA.{h,cpp} — sha256, SHA256
(streaming)."""

from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


class SHA256:
    """Streaming SHA-256 (reference: src/crypto/SHA.h — class SHA256)."""

    def __init__(self) -> None:
        self._h = hashlib.sha256()

    def add(self, data: bytes) -> "SHA256":
        self._h.update(data)
        return self

    def finish(self) -> bytes:
        return self._h.digest()
