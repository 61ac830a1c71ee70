"""VirtualClock / VirtualTimer — the event loop and determinism keystone.

Reference: src/util/Timer.{h,cpp} — VirtualClock (REAL_TIME vs VIRTUAL_TIME
modes), VirtualTimer, and the crank loop that the whole node lives in;
the fair action Scheduler is in scheduler.py.

VIRTUAL_TIME is what makes multi-node in-process simulation deterministic:
tests crank simulated time forward; timers fire in order with no wall-clock
dependency (SURVEY.md §4 "determinism backbone").
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from enum import Enum
from typing import Callable, List, Optional, Tuple

from .scheduler import Scheduler


class ClockMode(Enum):
    REAL_TIME = 0
    VIRTUAL_TIME = 1


def monotonic_now() -> float:
    """Real monotonic seconds — the blessed escape hatch for *infra*
    timing (metric rate windows, reservoir decay) that must track the
    host clock even under VIRTUAL_TIME.  Subsystem logic must go through
    a VirtualClock; corelint's clock-discipline rule enforces that this
    module (plus util/perf.py and bench.py) is the only wall-clock seam."""
    return _time.monotonic()


def wall_now() -> float:
    """Real wall-clock epoch seconds — the infra-level counterpart of
    system_now() for export timestamps (Chrome trace epochs, bench
    cache ages).  Same discipline as monotonic_now()."""
    return _time.time()


class VirtualClock:
    def __init__(self, mode: ClockMode = ClockMode.VIRTUAL_TIME) -> None:
        self.mode = mode
        self._virtual_now = 0.0
        self._heap: List[Tuple[float, int, "VirtualTimer", Callable[[], None]]] = []
        self._seq = itertools.count()
        self.scheduler = Scheduler()
        self._stopped = False
        # IO pumps: polled at the top of every crank (the asio-socket
        # integration point; reference: VirtualClock owns the io_context)
        self._io_pumps: List[Callable[[], int]] = []

    def add_io_pump(self, pump: Callable[[], int]) -> None:
        self._io_pumps.append(pump)

    def remove_io_pump(self, pump: Callable[[], int]) -> None:
        if pump in self._io_pumps:
            self._io_pumps.remove(pump)

    # -- time ---------------------------------------------------------------
    def now(self) -> float:
        if self.mode is ClockMode.REAL_TIME:
            return _time.monotonic()
        return self._virtual_now

    def system_now(self) -> int:
        """Wall-clock seconds (ledger close time source). In virtual mode the
        virtual offset is used so tests are reproducible."""
        if self.mode is ClockMode.REAL_TIME:
            return int(_time.time())
        return int(self._virtual_now)

    # -- scheduling ---------------------------------------------------------
    def post_action(self, fn: Callable[[], None], name: str = "", queue_type: int = 0) -> None:
        self.scheduler.enqueue(fn, name=name, queue_type=queue_type)

    def _schedule(self, when: float, timer: "VirtualTimer", fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (when, next(self._seq), timer, fn))

    # -- cranking -----------------------------------------------------------
    def crank(self, block: bool = False) -> int:
        """Run one batch of due work; returns number of events processed.
        In VIRTUAL_TIME, if nothing is runnable, time advances to the next
        timer deadline (reference: VirtualClock::crank advancing virtual time
        when the io_context is idle)."""
        if self._stopped:
            return 0
        progressed = 0
        for pump in list(self._io_pumps):
            progressed += pump()
        progressed += self.scheduler.run_one_batch()
        now = self.now()
        while self._heap and self._heap[0][0] <= now:
            _, _, timer, fn = heapq.heappop(self._heap)
            if not timer.cancelled:
                timer._pending -= 1
                fn()
                progressed += 1
        if progressed == 0 and self.mode is ClockMode.VIRTUAL_TIME and self._heap:
            # advance virtual time to the next deadline
            self._virtual_now = max(self._virtual_now, self._heap[0][0])
            progressed += self.crank()
        return progressed

    def crank_until(self, pred: Callable[[], bool], timeout: float) -> bool:
        """Crank until pred() or (virtual) timeout elapsed. Reference:
        Simulation::crankUntil."""
        deadline = self.now() + timeout
        while self.now() <= deadline:
            if pred():
                return True
            if self.crank() == 0 and not self._heap and self.scheduler.empty():
                if self.mode is ClockMode.VIRTUAL_TIME:
                    return pred()
                _time.sleep(0.001)
        return pred()

    def crank_for(self, duration: float) -> None:
        deadline = self.now() + duration
        while self.now() < deadline:
            if self.crank() == 0 and not self._heap and self.scheduler.empty():
                if self.mode is ClockMode.VIRTUAL_TIME:
                    self._virtual_now = deadline
                    return
                _time.sleep(0.001)

    def stop(self) -> None:
        self._stopped = True


class VirtualTimer:
    """One-shot/repeating timer bound to a VirtualClock.
    Reference: src/util/Timer.h — VirtualTimer::expires_from_now + async_wait."""

    def __init__(self, clock: VirtualClock) -> None:
        self._clock = clock
        self.cancelled = False
        self._pending = 0

    def expires_from_now(self, delay: float, fn: Callable[[], None],
                         on_cancel: Optional[Callable[[], None]] = None) -> None:
        self.cancelled = False
        self._pending += 1
        self._clock._schedule(self._clock.now() + delay, self, fn)

    def expires_at(self, when: float, fn: Callable[[], None]) -> None:
        self.cancelled = False
        self._pending += 1
        self._clock._schedule(when, self, fn)

    def cancel(self) -> None:
        self.cancelled = True

    @property
    def seated(self) -> bool:
        return self._pending > 0 and not self.cancelled
