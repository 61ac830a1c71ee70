"""Maintainer: periodic garbage collection of old node data.

Reference: src/main/Maintainer.{h,cpp} — on a timer (and via the
`/maintenance` endpoint) deletes aged-out rows (scphistory, txhistory,
superseded headers) outside the retention window, and forgets unreferenced
bucket files.  The publish queue bounds how much may be deleted: history not
yet published must be retained.
"""

from __future__ import annotations

from ..history.archive import checkpoint_frequency
from ..util import logging as slog

log = slog.get("Main")

# reference default: AUTOMATIC_MAINTENANCE_PERIOD=359s / COUNT=400 rows;
# here maintenance is small, so a per-checkpoint cadence is enough
DEFAULT_PERIOD = 300.0
RETAIN_CHECKPOINTS = 2


class Maintainer:
    def __init__(self, app, period: float = DEFAULT_PERIOD):
        self.app = app
        self.period = period
        self._timer = None

    def start(self) -> None:
        from ..util.clock import VirtualTimer
        self._timer = VirtualTimer(self.app.clock)

        def tick() -> None:
            try:
                self.perform_maintenance()
            except Exception as e:  # GC must never take the node down
                log.error("maintenance failed: %s", e)
            self._timer.expires_from_now(self.period, tick)

        self._timer.expires_from_now(self.period, tick)

    def perform_maintenance(self) -> dict:
        """One GC round; returns what was done (also the `/maintenance`
        response payload)."""
        app = self.app
        out = {"removed_buckets": 0, "pruned_below": None}
        if app.database is None:
            return out
        lcl = app.lm.last_closed_ledger_seq
        # never prune past the oldest unpublished checkpoint
        queued = [seq for seq, _ in app.database.publish_queue()]
        floor = min(queued) if queued else lcl
        keep_from = max(2, min(floor, lcl)
                        - RETAIN_CHECKPOINTS * checkpoint_frequency())
        app.database.prune_scp(keep_from)
        app.database.prune_tx_history(keep_from)
        app.database.delete_old_headers(keep_from)
        app.database.commit()
        out["pruned_below"] = keep_from
        if app.bucket_dir is not None:
            out["removed_buckets"] = app.bucket_dir.gc(
                app.lm.bucket_list.referenced_hashes())
        log.info("maintenance: pruned below %d, removed %d bucket files",
                 keep_from, out["removed_buckets"])
        return out
