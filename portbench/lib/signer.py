"""Ed25519 key pairs and signatures for the benchmark's inputs, made on
the host in set-up by OpenSSL through `cryptography`.  Ed25519 signing is
deterministic (RFC 8032), so a seed always gives the same bytes."""

from __future__ import annotations

from cryptography.hazmat.primitives.asymmetric.ed25519 import \
    Ed25519PrivateKey
from cryptography.hazmat.primitives.serialization import (Encoding,
                                                          PublicFormat)


def public_keys(seeds: list) -> list:
    """The 32-byte public key of each 32-byte seed."""
    return [Ed25519PrivateKey.from_private_bytes(s).public_key()
            .public_bytes(Encoding.Raw, PublicFormat.Raw) for s in seeds]


def sign_all(items: list) -> list:
    """The signature of each (seed, public key, message)."""
    return [Ed25519PrivateKey.from_private_bytes(s).sign(m)
            for s, _, m in items]
