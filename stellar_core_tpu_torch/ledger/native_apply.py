"""Bridge between the Python LedgerManager state and the native apply
engine (native/capply.c).

Reference: SURVEY.md §3.3 — the catchup replay hot loop.  The native
engine owns the ledger state (entry store + bucket list + header) while a
catchup replays supported checkpoints; anything the probe rejects (fee
bumps, ops outside the native set, generalized tx sets) falls back to the
Python engine for that checkpoint after an export/import round-trip.
State transfer is exact: entries as (LedgerKey XDR, LedgerEntry XDR)
pairs, buckets as aligned (sort-key, record) lists / serialized streams,
pending merges resolved (outputs are pure functions of inputs, so eager
resolution is hash-identical to the lazy merge pipeline).

Kill switch: STELLAR_TPU_NO_CAPPLY forces the Python path everywhere.

The engine verifies a signature its verify cache misses with libsodium,
which it loads itself (dlopen).  Seeding cannot rule misses out (the
cache is direct-mapped: a later seeded pair evicts an earlier one that
shares its slot), and where libsodium does not load every miss is a
rejected signature.  So the engine counts as available only where both
the extension and libsodium load; elsewhere every close runs in Python.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, Optional, Sequence

from .. import xdr as X
from ..bucket.bucket import Bucket
from ..bucket.future import FutureBucket

try:
    if os.environ.get("STELLAR_TPU_NO_CAPPLY"):
        raise ImportError("capply disabled by STELLAR_TPU_NO_CAPPLY")
    # native/capply.c, built at first use (rebuilt when the source is
    # newer); a missing compiler or a failed build leaves the Python path,
    # but a library that is present, stale and cannot be rebuilt
    # fail-stops (StaleNativeExtensionError), as the reference's does
    from .. import _native_build
    _native_build.require_fresh("_capply")
    _capply = _native_build.load("_capply")
except ImportError:
    _capply = None

# the names native/capply.c's load_sodium() tries, in its order
SODIUM_NAMES = ("libsodium.so.23", "libsodium.so", "libsodium.dylib")


@functools.lru_cache(maxsize=None)
def libsodium_loads() -> bool:
    """True when one of SODIUM_NAMES loads and exports
    crypto_sign_verify_detached: the engine's own probe, made here."""
    for name in SODIUM_NAMES:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        if hasattr(lib, "crypto_sign_verify_detached"):
            return True
    return False


def native_apply_available() -> bool:
    return _capply is not None and libsodium_loads()


def _bucket_tuple(bucket: Bucket):
    # raw_records: a disk-resident bucket slices its file (transient list,
    # nothing cached) — no BucketEntry decode on the import path
    return (bucket.sort_keys(), bucket.raw_records(),
            bucket.protocol_version)


class NativeApplyBridge:
    """Owns a _capply.Engine and tracks where the authoritative state
    lives (`active`: in the engine; otherwise: in the Python manager)."""

    def __init__(self, network_id: bytes):
        if not native_apply_available():
            raise RuntimeError("native apply engine not built, or "
                               "libsodium does not load")
        self.engine = _capply.Engine(network_id)
        self.active = False
        # per-checkpoint outcome accounting (historywork fills these, so
        # a silent fallback regression shows in native vs fallback)
        self.native_checkpoints = 0
        self.fallback_checkpoints = 0

    # -- state transfer ----------------------------------------------------
    def import_from(self, mgr) -> None:
        """Python manager -> engine (authoritative state moves to C).
        Works for both root flavors: the BucketListDB root streams raw
        records straight from its indexed bucket files (no Python entry
        decode), the dict root serializes its entries."""
        entries = mgr.root.export_raw_entries()
        buckets = []
        nexts = []
        for lvl in mgr.bucket_list.levels:
            buckets.append(_bucket_tuple(lvl.curr))
            buckets.append(_bucket_tuple(lvl.snap))
            nexts.append(None if lvl.next is None
                         else _bucket_tuple(lvl.next.resolve()))
        self.engine.import_state(mgr.lcl_header.to_xdr(), mgr.lcl_hash,
                                 entries, buckets, nexts)
        self.active = True

    def export_to_manager(self, mgr) -> None:
        """Engine -> Python manager (authoritative state moves back)."""
        self._export_into(mgr)
        self.active = False

    def _export_into(self, mgr) -> None:
        """Copy the engine state into `mgr` WITHOUT transferring authority
        (the differential spot-checks of native live close build scratch
        managers this way).  The bucket list is rebuilt first and
        hash-verified; only then is the root rebound — a BucketListDB
        root is rebuilt OVER that list (ignoring the exported entry
        pairs, no decode), a dict root materializes them."""
        hdr, lcl_hash, entries, bucket_streams, next_streams = \
            self.engine.export_state()
        header = X.LedgerHeader.from_xdr(hdr)
        for i, lvl in enumerate(mgr.bucket_list.levels):
            lvl.curr = Bucket.deserialize(bucket_streams[2 * i])
            lvl.snap = Bucket.deserialize(bucket_streams[2 * i + 1])
            ns = next_streams[i]
            lvl.next = (None if ns is None
                        else FutureBucket.from_output(Bucket.deserialize(ns)))
        if mgr.bucket_list.hash() != header.bucketListHash:
            raise RuntimeError(
                "native state export diverged from the bucket list hash")
        mgr.root = mgr.build_root(header, entries)
        mgr.lcl_header = header
        mgr.lcl_hash = lcl_hash

    def sync_buckets_to(self, mgr) -> None:
        """Rebuild `mgr`'s PYTHON bucket list from the engine (authority
        stays in C) — the live-close checkpoint-boundary seam: history
        publishing and persistence read `mgr.bucket_list` directly.
        Uses the entries-free export: boundaries must not pay an
        O(all-entries) Python materialization every 64 ledgers."""
        hdr, bucket_streams, next_streams = self.engine.export_buckets()
        header = X.LedgerHeader.from_xdr(hdr)
        for i, lvl in enumerate(mgr.bucket_list.levels):
            lvl.curr = Bucket.deserialize(bucket_streams[2 * i])
            lvl.snap = Bucket.deserialize(bucket_streams[2 * i + 1])
            ns = next_streams[i]
            lvl.next = (None if ns is None
                        else FutureBucket.from_output(Bucket.deserialize(ns)))
        if mgr.bucket_list.hash() != header.bucketListHash:
            raise RuntimeError(
                "native bucket sync diverged from the bucket list hash")

    # -- live close ---------------------------------------------------------
    def close_ledger(self, tx_rec: Optional[bytes], scp_value_xdr: bytes):
        """Drive one live ledger close in C.  Returns (seq, lcl_hash,
        header_xdr, result_set_xdr, delta) — delta is the ledger's entry
        changes as (key XDR, entry XDR | None) pairs for the Python
        read-mirror.  Raises _capply.Error on probe misses / divergence;
        the engine rolls back cleanly unless `poisoned` reports
        otherwise."""
        return self.engine.close_ledger(tx_rec, scp_value_xdr)

    # -- replay ------------------------------------------------------------
    def probe(self, tx_recs: Sequence[Optional[bytes]]) -> bool:
        return bool(self.engine.probe(list(tx_recs)))

    def apply_checkpoint(self, header_recs: List[bytes],
                         tx_recs: List[Optional[bytes]],
                         max_seq: int) -> int:
        return self.engine.apply_checkpoint(header_recs, tx_recs, max_seq)

    def extract_pairs(self, tx_recs: Sequence[Optional[bytes]]):
        """Accel pairing without Python frame decode: returns (pks, sigs,
        msgs, total_sigs) for every hint-pairable signature in the raw
        records, using the engine state's account signers plus the
        cumulative SetOptions harvest (exactly the PreverifyPipeline
        pairing contract — unpaired signatures fall back to CPU verify)."""
        return self.engine.extract_pairs(list(tx_recs))

    def seed_verdicts(self, pks, sigs, msgs, verdicts) -> None:
        """Preverify hook: push the card's batch-verified signature
        verdicts into the engine's verify cache (identical to the Python
        seam in crypto/keys.py — a miss just recomputes via libsodium)."""
        self.engine.seed_verdicts(list(pks), list(sigs), list(msgs),
                                  [bool(v) for v in verdicts])

    def lcl(self):
        return self.engine.lcl()

    def stats(self) -> dict:
        return self.engine.stats()
