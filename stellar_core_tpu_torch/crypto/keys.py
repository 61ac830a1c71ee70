"""Key types and signature verification with the verify-result cache.

Reference: src/crypto/SecretKey.{h,cpp} — SecretKey, PublicKey,
PubKeyUtils::verifySig (libsodium verify + RandomEvictionCache keyed by
hash(sig‖key‖msg)), KeyUtils; src/crypto/SignerKey.h.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from . import sodium, strkey
from .sha import sha256
from ..util.cache import RandomEvictionCache
from ..util.lockorder import make_lock
from ..util.metrics import registry as _registry

VERIFY_CACHE_SIZE = 0x10000  # reference: 64k-entry verify cache


@dataclass(frozen=True)
class PublicKey:
    """Ed25519 public key (XDR: PublicKey{PUBLIC_KEY_TYPE_ED25519, uint256})."""

    ed25519: bytes  # 32 bytes

    def __post_init__(self) -> None:
        if len(self.ed25519) != 32:
            raise ValueError("ed25519 public key must be 32 bytes")

    def to_strkey(self) -> str:
        return strkey.encode_public_key(self.ed25519)

    @staticmethod
    def from_strkey(s: str) -> "PublicKey":
        return PublicKey(strkey.decode_public_key(s))

    def hint(self) -> bytes:
        """Signature hint: last 4 bytes of the key (XDR SignatureHint).
        Reference: src/crypto/SignerKeyUtils / SignatureUtils — getHint."""
        return self.ed25519[28:32]

    def __repr__(self) -> str:
        return f"PublicKey({self.to_strkey()})"


class SecretKey:
    """Reference: src/crypto/SecretKey.h — SecretKey (seed + expanded key)."""

    __slots__ = ("_seed", "_sk", "public_key")

    def __init__(self, seed: bytes) -> None:
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        pk, sk = sodium.sign_seed_keypair(seed)
        self._seed = seed
        self._sk = sk
        self.public_key = PublicKey(pk)

    @staticmethod
    def random() -> "SecretKey":
        return SecretKey(os.urandom(32))

    @staticmethod
    def pseudo_random_for_testing(rng) -> "SecretKey":
        return SecretKey(bytes(rng.randrange(256) for _ in range(32)))

    @staticmethod
    def from_strkey_seed(s: str) -> "SecretKey":
        return SecretKey(strkey.decode_seed(s))

    def to_strkey_seed(self) -> str:
        return strkey.encode_seed(self._seed)

    def sign(self, msg: bytes) -> bytes:
        return sodium.sign_detached(msg, self._sk)

    def __repr__(self) -> str:
        return f"SecretKey({self.public_key.to_strkey()})"


class _VerifyCache:
    def __init__(self) -> None:
        self._cache: RandomEvictionCache[tuple, bool] = RandomEvictionCache(VERIFY_CACHE_SIZE)
        self._lock = make_lock("crypto.verify-cache")

    @staticmethod
    def key(sig: bytes, pk: bytes, msg: bytes) -> tuple:
        """Tuple key, not a whole-entry digest: CPython caches each bytes
        object's hash, and the replay path looks up the very same
        sig/pk/msg objects it seeded (frames are decoded once), so keying
        costs one cached-hash tuple combine instead of a 128-byte SHA-256
        per probe.  Large messages (SCP envelope payloads etc.) are
        digested so a full cache never pins megabytes of dropped-envelope
        bytes; replay content-hashes are exactly 32 bytes and stay raw."""
        if len(msg) > 64:
            msg = sha256(msg)
        return (sig, pk, msg)

    def get(self, k: tuple) -> Optional[bool]:
        with self._lock:
            return self._cache.maybe_get(k)

    def put(self, k: tuple, verdict: bool) -> None:
        with self._lock:
            self._cache.put(k, verdict)

    def put_many(self, entries) -> None:
        """Bulk insert of (pk, sig, msg, verdict) under ONE lock
        acquisition (the replay pipeline seeds tens of thousands of
        verdicts per collect on the apply thread)."""
        key = self.key
        with self._lock:
            put = self._cache.put
            for pk, sig, msg, verdict in entries:
                put(key(sig, pk, msg), bool(verdict))

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()


_verify_cache = _VerifyCache()


def verify_sig(pk: PublicKey, sig: bytes, msg: bytes) -> bool:
    """PubKeyUtils::verifySig equivalent: cached libsodium-exact verdict.

    The card's batch path (accel.ed25519.verify_batch_async) pre-verifies
    whole work units and seeds this cache, so per-tx checks hit without
    recompute — same observable semantics, hoisted compute.
    """
    k = _VerifyCache.key(sig, pk.ed25519, msg)
    hit = _verify_cache.get(k)
    if hit is not None:
        _registry().counter("crypto.verify.cache-hit").inc()
        return hit
    # cache miss: the verdict is recomputed by libsodium on the host —
    # during an accel catchup this counter is the un-offloaded remainder
    # (unpairable hints + wedge/race fallbacks)
    _registry().counter("crypto.verify.recompute").inc()
    verdict = sodium.verify_detached(sig, msg, pk.ed25519)
    _verify_cache.put(k, verdict)
    return verdict


def seed_verify_cache(entries) -> None:
    """Bulk-insert (pk32, sig, msg, verdict) tuples (the card's batch path
    seeds the cache through this)."""
    _verify_cache.put_many(entries)


def clear_verify_cache() -> None:
    _verify_cache.clear()
