"""Herder layer: SCP↔ledger glue, tx queue, upgrades, quorum analysis.

Reference: src/herder/ (SURVEY.md §2.1).
"""

from .herder import (EXP_LEDGER_TIMESPAN_SECONDS, Herder, HerderState,
                     MAX_SLOTS_TO_REMEMBER)
from .pending_envelopes import (ENVELOPE_STATUS_DISCARDED,
                                ENVELOPE_STATUS_FETCHING,
                                ENVELOPE_STATUS_PROCESSED,
                                ENVELOPE_STATUS_READY, PendingEnvelopes)
from .quorum_intersection import (QuorumIntersectionChecker,
                                  QuorumIntersectionResult,
                                  check_intersection,
                                  intersection_critical_groups)
from .quorum_tracker import QuorumTracker
from .tx_queue import AddResult, TransactionQueue
from .upgrades import UpgradeParameters, Upgrades

__all__ = [
    "EXP_LEDGER_TIMESPAN_SECONDS", "Herder", "HerderState",
    "MAX_SLOTS_TO_REMEMBER", "ENVELOPE_STATUS_DISCARDED",
    "ENVELOPE_STATUS_FETCHING", "ENVELOPE_STATUS_PROCESSED",
    "ENVELOPE_STATUS_READY", "PendingEnvelopes",
    "QuorumIntersectionChecker", "QuorumIntersectionResult",
    "check_intersection", "intersection_critical_groups", "QuorumTracker",
    "AddResult", "TransactionQueue", "UpgradeParameters", "Upgrades",
]
