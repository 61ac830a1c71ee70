"""StatusManager + node health derivation.

Reference: src/main/StatusManager.{h,cpp} — one current status string per
category (newest wins), removed on recovery, surfaced as the ``status``
lines in ``/info``.  On top of the status lines this module derives a
machine-readable health verdict (``/health`` + the ``node.health``
gauge) suitable for load-balancer probes: ledger age vs. the close
target, herder state, tx-queue depth, overlay peer count and the bucket
GC backlog, each with an explicit reason string when degraded.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..util.clock import monotonic_now

# Reference StatusManager categories, extended with the subsystems this
# node actually reports on.
STATUS_CATEGORIES = (
    "history-catchup",
    "history-publish",
    "scp",
    "overlay",
    "bucket",
    "ledger",
    "requires-upgrades",
)


class StatusManager:
    """Per-category current-status strings (reference semantics: the
    NEWEST status per category is the only one kept; a recovered
    subsystem clears its category)."""

    def __init__(self) -> None:
        self._statuses: Dict[str, str] = {}

    def set_status(self, category: str, msg: str) -> None:
        if category not in STATUS_CATEGORIES:
            raise ValueError(f"unknown status category {category!r}")
        self._statuses[category] = msg

    def clear_status(self, category: str) -> None:
        self._statuses.pop(category, None)

    def get_status(self, category: str) -> Optional[str]:
        return self._statuses.get(category)

    def statuses(self) -> Dict[str, str]:
        return dict(self._statuses)

    def status_lines(self) -> List[str]:
        """The /info ``status`` array (reference: the strings
        StatusManager contributes to the info response)."""
        return [f"[{cat}] {msg}" for cat, msg in
                sorted(self._statuses.items())]

    def __len__(self) -> int:
        return len(self._statuses)


# ---------------------------------------------------------------------------
# health derivation
# ---------------------------------------------------------------------------

# Degraded when the LCL is older than this many close targets — one
# missed round is jitter, two means the node is not keeping consensus
# pace (reference shape: the /info "age" an operator watches).
HEALTH_LEDGER_AGE_FACTOR = 2.0
# tx-queue depth beyond this many maximum tx sets signals backpressure
# the node cannot drain
HEALTH_TX_QUEUE_FACTOR = 4
# unreclaimed bucket files beyond the referenced+pinned set tolerated
# before GC is considered backlogged
HEALTH_BUCKET_GC_BACKLOG = 512
# backlog probe cadence: the directory listing is re-taken at most this
# often; probes in between serve the cached count
GC_BACKLOG_TTL_S = 5.0


def _bucket_gc_backlog(app) -> int:
    """Bucket files on disk that neither the live list references nor any
    snapshot pins — what the next GC pass would delete.  0 when the node
    runs in-memory.

    Deliberately LOCK-FREE and cached: /health must keep answering while
    the main loop is stalled (possibly INSIDE the bucket store lock — a
    wedged merge adopt is a realistic stall), so this never acquires the
    store lock; the pin set is read as a GIL-atomic dict snapshot
    (approximate by design — a probe tolerates a torn read), and the
    directory listing is taken at most once per GC_BACKLOG_TTL_S so
    Prometheus scrapes of node.health don't re-list a thousands-of-files
    bucket dir each time."""
    store = getattr(app, "bucket_store", None)
    if store is None:
        return 0
    cached = getattr(app, "_gc_backlog_cache", None)
    now = monotonic_now()
    if cached is not None and now - cached[0] < GC_BACKLOG_TTL_S:
        return cached[1]
    try:
        keep = set(app.lm.bucket_list.referenced_hashes())
        keep.update(list(store._pins))
        backlog = 0
        for name in os.listdir(store.path):
            if name.startswith("bucket-") and name.endswith(".xdr") \
                    and name[len("bucket-"):-len(".xdr")] not in keep:
                backlog += 1
    except RuntimeError:
        # pins/levels mutated mid-iteration (lock-free by design): keep
        # the previous reading rather than block or fail the probe
        return cached[1] if cached is not None else 0
    app._gc_backlog_cache = (now, backlog)
    return backlog


def evaluate_health(app) -> dict:
    """The /health document: ``status`` is "ok" or "degraded" with one
    reason string per failing check; ``checks`` carries the raw numbers
    either way so a probe's logs explain themselves."""
    from ..herder.herder import HerderState

    reasons: List[str] = []
    close_target = float(app.herder.ledger_timespan)
    age = max(0.0, app.clock.system_now()
              - app.lm.lcl_header.scpValue.closeTime)
    max_age = HEALTH_LEDGER_AGE_FACTOR * close_target
    if age > max_age:
        reasons.append(f"ledger age {age:.1f}s exceeds "
                       f"{max_age:.1f}s ({HEALTH_LEDGER_AGE_FACTOR:g}x "
                       f"close target)")

    state = app.herder.get_state_human()
    if state != HerderState.TRACKING:
        reasons.append(f"herder state is {state!r}, not tracking")

    depth = app.herder.tx_queue.size
    max_depth = HEALTH_TX_QUEUE_FACTOR * max(
        1, app.lm.lcl_header.maxTxSetSize)
    if depth > max_depth:
        reasons.append(f"tx queue depth {depth} exceeds {max_depth}")

    # sustained admission backlog: the pipeline's hysteresis valve is the
    # "sustained" filter (engages at the high watermark, clears only at
    # the low one) — while engaged, this node is shedding/throttling
    # intake and a load balancer should route around it
    adm = getattr(app.herder, "admission", None)
    adm_depth = adm.depth if adm is not None else 0
    if adm is not None and adm.backpressured:
        reasons.append(f"admission backlog {adm_depth} "
                       f"(back-pressure engaged at "
                       f"{adm.backpressure_high})")

    peers = app.overlay.num_authenticated()
    # an app without a config (e.g. a simulated in-process node) is by
    # definition part of a network and expects peers
    cfg = getattr(app, "config", None)
    standalone = cfg is not None and (cfg.RUN_STANDALONE
                                      or not cfg.KNOWN_PEERS)
    if peers == 0 and not standalone:
        reasons.append("no authenticated peers")

    backlog = _bucket_gc_backlog(app)
    if backlog > HEALTH_BUCKET_GC_BACKLOG:
        reasons.append(f"bucket GC backlog {backlog} files")

    # archive recovery in flight: a distinct degraded status ("the node
    # is resyncing from a history archive and will be back") vs plain
    # out-of-sync ("the node is stuck and needs attention").  Both answer
    # non-"ok", so probes and load balancers route around it either way.
    catchup_msg = app.status.get_status("history-catchup")
    if catchup_msg is not None:
        reasons.append(f"catching up from archive: {catchup_msg}")

    status = "ok" if not reasons \
        else ("catching-up" if catchup_msg is not None else "degraded")
    return {
        "status": status,
        "reasons": reasons,
        "checks": {
            "ledger_age_s": round(age, 1),
            "close_target_s": close_target,
            "herder_state": state,
            "tx_queue_depth": depth,
            "admission_backlog": adm_depth,
            "authenticated_peers": peers,
            "bucket_gc_backlog": backlog,
            "catching_up": catchup_msg is not None,
        },
        "statuses": app.status.statuses(),
    }


def health_gauge_value(app) -> float:
    """node.health: 1.0 healthy, 0.0 degraded (the gauge form of
    /health, for alerting off the Prometheus exposition)."""
    return 1.0 if evaluate_health(app)["status"] == "ok" else 0.0
