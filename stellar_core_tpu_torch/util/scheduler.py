"""Fair multi-queue action scheduler with load-shedding.

Reference: src/util/Scheduler.{h,cpp} — actions posted to named queues;
the scheduler runs queues fairly (least-total-service first) and can shed
DROPPABLE actions when overloaded.
"""

from __future__ import annotations

import collections
from typing import Callable, Deque, Dict, Tuple

ACTION_NORMAL = 0
ACTION_DROPPABLE = 1

MAX_QUEUE_DEPTH = 10_000


class Scheduler:
    def __init__(self) -> None:
        self._queues: Dict[str, Deque[Tuple[Callable[[], None], int]]] = {}
        self._service: Dict[str, int] = collections.defaultdict(int)
        self.dropped = 0

    def enqueue(self, fn: Callable[[], None], name: str = "", queue_type: int = ACTION_NORMAL) -> None:
        q = self._queues.setdefault(name, collections.deque())
        if queue_type == ACTION_DROPPABLE and len(q) >= MAX_QUEUE_DEPTH:
            self.dropped += 1
            return
        q.append((fn, queue_type))

    def empty(self) -> bool:
        return all(not q for q in self._queues.values())

    def size(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def run_one_batch(self, max_actions: int = 100) -> int:
        """Run up to max_actions, serving the least-serviced nonempty queue
        first (the reference's fairness discipline)."""
        ran = 0
        while ran < max_actions:
            nonempty = [n for n, q in self._queues.items() if q]
            if not nonempty:
                break
            name = min(nonempty, key=lambda n: self._service[n])
            fn, _ = self._queues[name].popleft()
            self._service[name] += 1
            fn()
            ran += 1
        return ran
