"""corelint rule catalogue — one module per repo invariant."""

from __future__ import annotations

from typing import List

from ..core import Rule
from .clock import ClockDisciplineRule
from .decode_free import DecodeFreeSeamRule
from .determinism import (FloatDisciplineRule, HashOrderRule,
                          IterationOrderRule, RngDisciplineRule)
from .eventlog import EventlogPartitionRule
from .exceptions import ExceptionHygieneRule
from .ledger_txn import LedgerTxnPathsRule
from .lock_order import LockOrderRule
from .metric_names import MetricRegistryRule
from .native_c import NATIVE_C_RULE_CLASSES
from .thread_safety import RawLockRule, ThreadSafetyRule

ALL_RULE_CLASSES = (
    ClockDisciplineRule,
    LedgerTxnPathsRule,
    DecodeFreeSeamRule,
    ExceptionHygieneRule,
    MetricRegistryRule,
    EventlogPartitionRule,
    LockOrderRule,
    ThreadSafetyRule,
    RawLockRule,
    IterationOrderRule,
    FloatDisciplineRule,
    HashOrderRule,
    RngDisciplineRule,
) + NATIVE_C_RULE_CLASSES


def all_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULE_CLASSES]


def rules_by_id(ids) -> List[Rule]:
    wanted = set(ids)
    known = {cls.id: cls for cls in ALL_RULE_CLASSES}
    unknown = wanted - set(known)
    if unknown:
        raise KeyError(f"unknown rule id(s): {sorted(unknown)}")
    return [known[i]() for i in sorted(wanted)]
