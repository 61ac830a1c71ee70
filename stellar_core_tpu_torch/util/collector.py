"""The cyclic collector's schedule, set once a process at package import.

A catchup builds a large long-lived state: the bucket apply's entries,
each ledger's decoded transaction set, the close artifacts.  Under the
interpreter's default threshold (700, 10, 10) a young pass runs every 700
net allocations and a full pass follows every hundredth young pass once
the old generation has grown by a quarter, so a replay pays full passes
that walk the state it is still building.  `install_schedule()` raises
the young-generation threshold and keeps the older two.  The collector
stays enabled and nothing is frozen: a finished catchup's state is freed
by reference counts (a finished work tree holds no cycle, work/work.py),
so the rarer passes find little garbage.

The setting is the process's, not a catchup's: a validator taking `/tx`
runs under it too.  On an H100's host its `/tx` tails did not lengthen:
over 5 pairs against the interpreter's schedule the p95 confirmation read
5.4351 s against 5.4584 and the p95 reply 1,067.8 ms against 1,079.6; its
longest pause fell from 304-447 ms (4 full passes a window) to 104-125
ms (one middle pass), beside 10 young passes, the longest 36-58 ms
(PERF.md §6).
"""

from __future__ import annotations

import gc

# Chosen from the catchup cell's measured speed on an H100's host, not
# derived: at 10,000 a 50 s replay ran 7-9 full passes and read 2.59-3.73
# ledgers/s; at 50,000 it ran 1 and was the faster on 5 of 6 seeds
# (PERF.md §6).  For scale: a 1,000-operation tx set (pubnet's limit)
# decodes into about 16,400 tracked objects, so 50,000 is about three
# full ledgers' decoded transactions.
YOUNG_THRESHOLD = 50_000


def install_schedule() -> None:
    """Raise the young-generation threshold to at least YOUNG_THRESHOLD,
    the older thresholds kept."""
    young, *older = gc.get_threshold()
    gc.set_threshold(max(young, YOUNG_THRESHOLD), *older)
