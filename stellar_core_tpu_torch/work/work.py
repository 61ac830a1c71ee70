"""The Work framework: cooperative, retryable task DAGs on the main thread.

Reference: src/work/BasicWork.{h,cpp} (state machine: PENDING/RUNNING/
WAITING/SUCCESS/FAILURE_RETRY/FAILURE_RAISE/ABORTED, retry with exponential
backoff), Work.{h,cpp} (works with children), WorkScheduler.{h,cpp} (the
root work cranked via the clock), WorkSequence.cpp, BatchWork.cpp
(bounded-concurrency fan-out), ConditionalWork.cpp, WorkWithCallback.cpp.

Redesign notes: the reference wakes works via asio handlers on the
VirtualClock; here a Work posts its crank steps as clock actions, giving
the same cooperative single-threaded semantics under virtual time (the
determinism backbone per SURVEY.md §4).  A work signals WAITING and is
woken by `wake_up()` (timers, children completing, external events).
"""

from __future__ import annotations

import enum
from typing import Callable, Iterator, List, Optional

from ..util import logging as slog
from ..util.clock import VirtualClock, VirtualTimer

log = slog.get("Work")

RETRY_NEVER = 0
RETRY_ONCE = 1
RETRY_A_FEW = 5
RETRY_A_LOT = 32
RETRY_FOREVER = 0xFFFFFFFF


class State(enum.Enum):
    # Reference: BasicWork::State / InternalState
    PENDING = "pending"
    RUNNING = "running"
    WAITING = "waiting"
    SUCCESS = "success"
    FAILURE = "failure"
    RETRYING = "retrying"
    ABORTING = "aborting"
    ABORTED = "aborted"


# onRun return values (reference: BasicWork::State returned by onRun)
RUN_SUCCESS = State.SUCCESS
RUN_FAILURE = State.FAILURE
RUN_RUNNING = State.RUNNING
RUN_WAITING = State.WAITING


def _is_done(state: State) -> bool:
    return state in (State.SUCCESS, State.FAILURE, State.ABORTED)


class BasicWork:
    """A unit of cooperative async work with retry semantics."""

    MAX_BACKOFF_EXPONENT = 5  # reference: BasicWork.cpp

    def __init__(self, clock: VirtualClock, name: str,
                 max_retries: int = RETRY_A_FEW):
        self.clock = clock
        self.name = name
        self.max_retries = max_retries
        self.state = State.PENDING
        self.retries = 0
        self._retry_timer: Optional[VirtualTimer] = None
        self._scheduled = False
        self._notify_parent: Optional[Callable[[], None]] = None

    # -- subclass interface ----------------------------------------------
    def on_run(self) -> State:
        raise NotImplementedError

    def on_reset(self) -> None:
        """Called when (re)starting, including before each retry."""

    def on_success(self) -> None:
        pass

    def on_failure_retry(self) -> None:
        pass

    def on_failure_raise(self) -> None:
        pass

    def on_aborted(self) -> None:
        pass

    # -- lifecycle --------------------------------------------------------
    def start(self, notify_parent: Optional[Callable[[], None]] = None) -> None:
        assert _is_done(self.state) or self.state == State.PENDING
        self._notify_parent = notify_parent
        self.state = State.RUNNING
        self.retries = 0
        self.on_reset()
        self._schedule_run()

    def shutdown(self) -> None:
        """Request abort.  Reference: BasicWork::shutdown."""
        if _is_done(self.state):
            return
        if self._retry_timer is not None:
            self._retry_timer.cancel()
            self._retry_timer = None
        self.state = State.ABORTING
        self._schedule_run()

    def wake_up(self) -> None:
        """Wake a WAITING work (timer fired, child finished, event arrived)."""
        if self.state == State.WAITING:
            self.state = State.RUNNING
            self._schedule_run()

    # -- internals --------------------------------------------------------
    def _schedule_run(self) -> None:
        if self._scheduled:
            return
        self._scheduled = True
        self.clock.post_action(self._crank, name=f"work:{self.name}")

    def _crank(self) -> None:
        self._scheduled = False
        if self.state == State.ABORTING:
            self._finish(State.ABORTED)
            return
        if self.state != State.RUNNING:
            return
        try:
            res = self.on_run()
        except Exception as e:  # a raising work is a failing work
            log.error("work %s raised: %s", self.name, e)
            res = State.FAILURE
        if res == State.RUNNING:
            self._schedule_run()
        elif res == State.WAITING:
            self.state = State.WAITING
        elif res == State.SUCCESS:
            self._finish(State.SUCCESS)
        elif res == State.FAILURE:
            self._maybe_retry()
        else:
            raise AssertionError(f"bad on_run result: {res}")

    def _maybe_retry(self) -> None:
        if self.retries >= self.max_retries:
            self._finish(State.FAILURE)
            return
        self.retries += 1
        self.state = State.RETRYING
        self.on_failure_retry()
        delay = self._retry_delay()
        log.debug("work %s retry %d/%s in %.1fs", self.name, self.retries,
                  self.max_retries, delay)
        self._retry_timer = VirtualTimer(self.clock)
        self._retry_timer.expires_from_now(delay, self._do_retry)

    def _retry_delay(self) -> float:
        # truncated binary exponential backoff, base 1s
        e = min(self.retries - 1, self.MAX_BACKOFF_EXPONENT)
        return float(1 << e)

    def _do_retry(self) -> None:
        self._retry_timer = None
        if self.state != State.RETRYING:
            return
        self.state = State.RUNNING
        self.on_reset()
        self._schedule_run()

    def _finish(self, state: State) -> None:
        self.state = state
        if state == State.SUCCESS:
            self.on_success()
        elif state == State.FAILURE:
            self.on_failure_raise()
        elif state == State.ABORTED:
            self.on_aborted()
        if self._notify_parent is not None:
            self._notify_parent()

    # -- status -----------------------------------------------------------
    @property
    def done(self) -> bool:
        return _is_done(self.state)

    @property
    def succeeded(self) -> bool:
        return self.state == State.SUCCESS

    @property
    def failed(self) -> bool:
        return self.state in (State.FAILURE, State.ABORTED)

    def status(self) -> str:
        return f"{self.name}: {self.state.value}"


class Work(BasicWork):
    """A work with children: runs children to completion (concurrently, as
    cooperative cranks), then runs its own on_run body via do_work().

    Reference: src/work/Work.{h,cpp} — addWork, yieldNextRunningChild,
    checkChildrenStatus.
    """

    def __init__(self, clock: VirtualClock, name: str,
                 max_retries: int = RETRY_A_FEW):
        super().__init__(clock, name, max_retries)
        self.children: List[BasicWork] = []
        self._any_child_failed = False

    def add_work(self, child: BasicWork) -> BasicWork:
        assert not self.done
        self.children.append(child)
        child.start(notify_parent=self._on_child_done)
        if self.state == State.WAITING:
            self.wake_up()
        return child

    def _on_child_done(self) -> None:
        self.wake_up()

    def on_reset(self) -> None:
        for c in self.children:
            if not c.done:
                c.shutdown()
        self.children = []
        self._any_child_failed = False
        self.do_reset()

    def do_reset(self) -> None:
        pass

    def do_work(self) -> State:
        """Run after all current children are done (and none failed)."""
        return State.SUCCESS

    def on_run(self) -> State:
        pending = [c for c in self.children if not c.done]
        if any(c.failed for c in self.children):
            return State.FAILURE
        if pending:
            return State.WAITING
        return self.do_work()

    def shutdown(self) -> None:
        for c in self.children:
            if not c.done:
                c.shutdown()
        super().shutdown()


class WorkScheduler(Work):
    """The root of the work DAG, owned by the Application.

    Reference: src/work/WorkScheduler.{h,cpp} — scheduleWork / executeWork.
    Children added here run until done; crank the clock to make progress.
    """

    def __init__(self, clock: VirtualClock):
        super().__init__(clock, "work-scheduler", max_retries=RETRY_NEVER)
        self.state = State.RUNNING  # always-on root

    def on_run(self) -> State:
        # the root never completes; it just keeps serving children
        if any(not c.done for c in self.children):
            return State.WAITING
        return State.WAITING

    def schedule(self, work: BasicWork) -> BasicWork:
        return self.add_work(work)

    def execute(self, work: BasicWork, timeout: float = 300.0) -> bool:
        """Blocking convenience: crank the clock until `work` finishes.
        Reference: WorkScheduler::executeWork."""
        self.schedule(work)
        self.clock.crank_until(lambda: work.done, timeout)
        return work.succeeded

    def _on_child_done(self) -> None:
        self.children = [c for c in self.children if not c.done]


class WorkSequence(BasicWork):
    """Runs a list of works strictly in order; fails on first failure.
    Reference: src/work/WorkSequence.{h,cpp}."""

    def __init__(self, clock: VirtualClock, name: str,
                 sequence: List[BasicWork],
                 max_retries: int = RETRY_NEVER):
        super().__init__(clock, name, max_retries)
        self.sequence = sequence
        self._idx = 0
        self._started_current = False

    def on_reset(self) -> None:
        self._idx = 0
        self._started_current = False

    def on_run(self) -> State:
        if self._idx >= len(self.sequence):
            return State.SUCCESS
        cur = self.sequence[self._idx]
        if not self._started_current:
            self._started_current = True
            cur.start(notify_parent=self.wake_up)
            return State.WAITING
        if not cur.done:
            return State.WAITING
        if cur.failed:
            return State.FAILURE
        self._idx += 1
        self._started_current = False
        return State.RUNNING

    def shutdown(self) -> None:
        if self._idx < len(self.sequence):
            cur = self.sequence[self._idx]
            if self._started_current and not cur.done:
                cur.shutdown()
        super().shutdown()


class BatchWork(Work):
    """Fan-out with bounded concurrency: pulls works from an iterator,
    keeping at most `max_concurrency` in flight.

    Reference: src/work/BatchWork.{h,cpp} (concurrency bound =
    MAX_CONCURRENT_SUBPROCESSES in the reference's download use).
    """

    def __init__(self, clock: VirtualClock, name: str,
                 iterator: Iterator[BasicWork], max_concurrency: int = 8,
                 max_retries: int = RETRY_NEVER):
        super().__init__(clock, name, max_retries)
        self._iter = iterator
        self.max_concurrency = max_concurrency
        self._exhausted = False

    def do_reset(self) -> None:
        self._exhausted = False

    def on_run(self) -> State:
        if any(c.failed for c in self.children):
            return State.FAILURE
        self.children = [c for c in self.children if not c.done]
        while not self._exhausted and len(self.children) < self.max_concurrency:
            try:
                nxt = next(self._iter)
            except StopIteration:
                self._exhausted = True
                break
            self.add_work(nxt)
        if self.children:
            return State.WAITING
        return State.SUCCESS


class ConditionalWork(BasicWork):
    """Waits for `condition()` then runs the wrapped work.
    Reference: src/work/ConditionalWork.{h,cpp} (polls the condition)."""

    POLL_INTERVAL = 0.5

    def __init__(self, clock: VirtualClock, name: str,
                 condition: Callable[[], bool], wrapped: BasicWork):
        super().__init__(clock, name, max_retries=RETRY_NEVER)
        self.condition = condition
        self.wrapped = wrapped
        self._started = False
        self._timer: Optional[VirtualTimer] = None

    def on_reset(self) -> None:
        self._started = False

    def on_run(self) -> State:
        if not self._started:
            if not self.condition():
                self._timer = VirtualTimer(self.clock)
                self._timer.expires_from_now(self.POLL_INTERVAL, self.wake_up)
                return State.WAITING
            self._started = True
            self.wrapped.start(notify_parent=self.wake_up)
            return State.WAITING
        if not self.wrapped.done:
            return State.WAITING
        return State.SUCCESS if self.wrapped.succeeded else State.FAILURE

    def shutdown(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        if self._started and not self.wrapped.done:
            self.wrapped.shutdown()
        super().shutdown()


class WorkWithCallback(BasicWork):
    """Runs a one-shot callback as a work step.
    Reference: src/work/WorkWithCallback.{h,cpp} (callback returns success)."""

    def __init__(self, clock: VirtualClock, name: str,
                 callback: Callable[[], bool],
                 max_retries: int = RETRY_NEVER):
        super().__init__(clock, name, max_retries)
        self.callback = callback

    def on_run(self) -> State:
        return State.SUCCESS if self.callback() else State.FAILURE


def function_work(clock: VirtualClock, name: str, fn: Callable[[], bool],
                  max_retries: int = RETRY_NEVER) -> WorkWithCallback:
    """Helper: wrap a bool-returning function as a schedulable work."""
    return WorkWithCallback(clock, name, fn, max_retries)
