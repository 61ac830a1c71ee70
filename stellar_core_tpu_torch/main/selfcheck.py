"""Self-check: cross-verify the node's durable state.

Reference: src/main/ApplicationUtils — selfCheck + the `self-check` CLI /
`/self-check` endpoint: re-hash the stored LCL header, check the bucket
list against it, re-hash every referenced bucket file, and probe archive
reachability.  All checks are read-only; the result is a pass/fail report
(the reference logs and returns an exit code — fail-stop is left to the
caller).

The copy of stellar_core_tpu/main/selfcheck.py, with one repair: a merge
that finished in memory but is not yet persisted is checked by its
inputs, which the stored state names, not by its output (the reference
reports such a node's buckets missing).
"""

from __future__ import annotations

from typing import List, Optional

from ..crypto.sha import sha256
from ..util import logging as slog

log = slog.get("Main")


def self_check(lm, database=None, bucket_dir=None,
               archives=()) -> dict:
    """Run every applicable check; returns {"ok": bool, "checks": [...]}."""
    checks: List[dict] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append({"name": name, "ok": bool(ok), "detail": detail})
        (log.info if ok else log.error)("self-check %s: %s %s",
                                        name, "OK" if ok else "FAIL", detail)

    # 1. LCL header self-consistency
    header_hash = sha256(lm.lcl_header.to_xdr())
    check("lcl-header-hash", header_hash == lm.lcl_hash,
          f"stored {lm.lcl_hash.hex()[:16]} recomputed "
          f"{header_hash.hex()[:16]}")

    # 2. live bucket list matches the header.  With native live close
    # the authoritative buckets live in the C engine between checkpoint
    # boundaries — rebuild the Python view first (hash-verified inside)
    if lm.native_closer is not None and lm.native_closer.bridge.active:
        lm.native_closer.bridge.sync_buckets_to(lm)
    check("bucket-list-hash",
          lm.bucket_list.hash() == lm.lcl_header.bucketListHash)

    # 3. DB round-trip of the header
    if database is not None:
        stored = database.load_header_by_hash(lm.lcl_hash)
        check("db-header", stored is not None
              and sha256(stored.to_xdr()) == lm.lcl_hash)

    # 4. on-disk bucket files re-hash to their names
    if bucket_dir is not None:
        def on_disk(hex_hash: str) -> bool:
            if hex_hash == "0" * 64:
                return True
            bucket = bucket_dir.load(hex_hash)   # load() re-hashes
            return bucket is not None and bucket.hash().hex() == hex_hash

        bad = [h[:16] for h in lm.bucket_list.referenced_hashes()
               if not on_disk(h)]
        # a merge that finished in memory after the last close (a
        # reloaded node re-runs the merges its stored state left pending)
        # has no file until the next close persists it; the stored state
        # still names its inputs, so those are what must be on disk
        for lvl in lm.bucket_list.levels:
            nxt = lvl.next
            if nxt is None or not nxt.done or nxt.inputs is None:
                continue
            out = nxt.resolve().hash().hex()
            if out[:16] in bad and all(on_disk(b.hash().hex())
                                       for b in nxt.inputs[:2]):
                bad.remove(out[:16])
        check("bucket-files", not bad, ",".join(bad))

    # 5. archives are reachable and their HAS parses; before the first
    # checkpoint publish an empty archive is the expected state
    from ..history.archive import checkpoint_frequency
    for i, archive in enumerate(archives):
        try:
            has = archive.get_state()
            if has is None:
                not_yet = lm.lcl_header.ledgerSeq < checkpoint_frequency()
                check(f"archive-{i}", not_yet,
                      "no HAS published yet" if not_yet
                      else "HAS missing after first checkpoint")
            else:
                check(f"archive-{i}", True,
                      f"currentLedger={has.current_ledger}")
        except Exception as e:  # corelint: disable=exception-hygiene -- the failure lands in the check result
            check(f"archive-{i}", False, str(e))

    return {"ok": all(c["ok"] for c in checks), "checks": checks}
