"""Per-close cost ledger: one structured cost row per sealed ledger.

Reference shape: stellar-core's per-ledger close diagnostics (the
`ledger close` log line plus the medida timers it summarizes) — but
retained and queryable.  `LedgerManager._close_ledger` emits one
``CloseCostRecord`` at the seal edge carrying the phase split (fee /
apply / seal from the existing nested spans), the bucket merge-stall
time the close spent blocked on an unresolved background merge, the
entry-cache hit/miss deltas for this close, the snapshot-pin count and
resident-entry delta, and the GC backlog — the unit of post-mortem
analysis for "why did ledger N take 400 ms?".

The ring is bounded (``STPU_CLOSECOST_CAPACITY``, default 1024 — ~85
minutes at a 5 s close cadence) and served incrementally at
``/closecosts?since=`` with the same watermark contract as /tracespans
and /timeseries: every record gets a monotonically increasing
``export_seq`` and ``doc(since)`` returns ``next_since``.

Writers run INSIDE the detguard "ledger-close" region — nothing here
touches a guarded primitive (the close hands in durations it measured
with ``time.perf_counter``; the ring itself is pure data + a traced
lock).  Readers are admin threads and the anomaly bundle writer, which
is why the ring is ``@race_checked``.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from ..util.lockorder import make_lock
from ..util.racetrace import race_checked

CLOSECOST_CAPACITY = int(os.environ.get("STPU_CLOSECOST_CAPACITY",
                                        "1024"))


@dataclass(frozen=True)
class CloseCostRecord:
    """The cost breakdown of one sealed ledger."""
    export_seq: int          # watermark for /closecosts?since=
    seq: int                 # ledger sequence
    txs: int                 # transactions applied
    total_s: float           # whole close, fee intake to seal
    fee_s: float             # fee-processing phase
    apply_s: float           # tx-apply phase
    seal_s: float            # seal phase (bucket add_batch + snapshot)
    merge_stall_s: float     # close blocked on unresolved merges
    cache_hits: int          # entry-cache hit delta this close
    cache_misses: int        # entry-cache miss delta this close
    pin_count: int           # live snapshot pins at seal
    resident_entries: int    # decoded bucket entries resident at seal
    resident_delta: int      # resident-entry change across the close
    gc_backlog: int          # closes since the last bucket-file GC


@race_checked
class CloseCostLedger:
    """Bounded ring of CloseCostRecords (newest kept).  Written by the
    close path (main thread / native closer fallback), read by admin
    /closecosts workers and the anomaly bundle writer — every access is
    under ``_lock``."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._ring: deque = deque(maxlen=capacity or CLOSECOST_CAPACITY)
        self._lock = make_lock("closecost.ring")
        self._next_seq = 0

    def add(self, **fields) -> CloseCostRecord:
        with self._lock:
            self._next_seq += 1
            rec = CloseCostRecord(export_seq=self._next_seq, **fields)
            self._ring.append(rec)
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def next_since(self) -> int:
        with self._lock:
            return self._next_seq

    def doc(self, since: int = 0) -> dict:
        """The /closecosts document: records with export_seq > since,
        oldest first, plus the next_since watermark."""
        with self._lock:
            records = [asdict(r) for r in self._ring
                       if r.export_seq > since]
            next_since = max(since, self._next_seq)
        return {"records": records, "next_since": next_since,
                "capacity": self._ring.maxlen}

    def recent(self, n: int) -> List[dict]:
        """The newest n records, oldest first (anomaly bundles)."""
        with self._lock:
            rows = list(self._ring)[-n:]
        return [asdict(r) for r in rows]

    def window(self, lo_seq: int, hi_seq: int) -> List[dict]:
        """Records for ledger sequences in [lo_seq, hi_seq]."""
        with self._lock:
            rows = [r for r in self._ring
                    if lo_seq <= r.seq <= hi_seq]
        return [asdict(r) for r in rows]

    def latest(self) -> Optional[dict]:
        with self._lock:
            return asdict(self._ring[-1]) if self._ring else None
