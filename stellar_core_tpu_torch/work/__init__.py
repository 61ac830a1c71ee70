"""Work framework: retryable async task DAGs on the VirtualClock.

Reference: src/work/ — BasicWork (state machine), Work (children),
WorkScheduler (root, cranked by the clock), WorkSequence, BatchWork
(bounded-concurrency fan-out), WorkWithCallback, ConditionalWork.
"""

from .work import (BasicWork, BatchWork, ConditionalWork, State, Work,
                   WorkScheduler, WorkSequence, WorkWithCallback,
                   function_work)

__all__ = ["BasicWork", "BatchWork", "ConditionalWork", "State", "Work",
           "WorkScheduler", "WorkSequence", "WorkWithCallback",
           "function_work"]
