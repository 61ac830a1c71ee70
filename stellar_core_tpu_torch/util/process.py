"""ProcessManager: async subprocess execution on the clock loop.

Reference: src/process/ProcessManager{,Impl}.{h,cpp} — runCommand returning
a ProcessExitEvent whose completion posts back onto the main loop; bounded
concurrency (MAX_CONCURRENT_SUBPROCESSES); kill-on-shutdown.  The reference
uses it for history get/put command templates (curl, gzip, aws cp); here
the same surface drives external archive commands.

Implementation: subprocess.Popen polled from a clock IO pump — no threads,
completion callbacks fire inside crank like every other event.
"""

from __future__ import annotations

import shlex
import signal
import subprocess
import time as _time
from typing import Callable, Deque, List, Optional
from collections import deque

from . import logging as slog
from .clock import VirtualClock, monotonic_now

log = slog.get("Process")

MAX_CONCURRENT_SUBPROCESSES = 8

# Default SIGTERM -> SIGKILL escalation window (reference:
# ProcessManagerImpl::shutdown kills outright; real node fleets need the
# children — themselves full nodes flushing sqlite/bucket state — a grace
# period to exit cleanly before the hard kill guarantees no orphans).
DEFAULT_GRACE_S = 5.0


class ProcessExitEvent:
    """Handle for one running (or queued) command."""

    def __init__(self, cmdline: str,
                 on_exit: Callable[[int], None],
                 output_path: Optional[str] = None):
        self.cmdline = cmdline
        self.on_exit = on_exit
        self.output_path = output_path   # combined stdout+stderr capture
        self.proc: Optional[subprocess.Popen] = None
        self.exit_code: Optional[int] = None
        self.cancelled = False
        self._out_fh = None
        self._kill_timer = None   # armed by ProcessManager.stop escalation

    def _close_output(self) -> None:
        if self._out_fh is not None:
            self._out_fh.close()
            self._out_fh = None

    @property
    def running(self) -> bool:
        return self.proc is not None and self.exit_code is None

    @property
    def done(self) -> bool:
        return self.exit_code is not None


class ProcessManager:
    def __init__(self, clock: VirtualClock,
                 max_concurrent: int = MAX_CONCURRENT_SUBPROCESSES):
        self.clock = clock
        self.max_concurrent = max_concurrent
        self._running: List[ProcessExitEvent] = []
        self._pending: Deque[ProcessExitEvent] = deque()
        self._shutdown = False
        clock.add_io_pump(self._pump)

    def run_command(self, cmdline: str,
                    on_exit: Callable[[int], None],
                    output_path: Optional[str] = None) -> ProcessExitEvent:
        """Queue a shell-less command; on_exit(code) fires on the clock loop
        (reference: ProcessManagerImpl::runProcess).  With `output_path`
        the child's stdout+stderr append to that file (the parallel-catchup
        range workers' post-mortem trail) instead of being discarded."""
        ev = ProcessExitEvent(cmdline, on_exit, output_path=output_path)
        self._pending.append(ev)
        self._maybe_start()
        return ev

    def cancel(self, ev: ProcessExitEvent) -> None:
        ev.cancelled = True
        if ev in self._pending:
            self._pending.remove(ev)
            ev.exit_code = -1
            return
        if ev.proc is not None and ev.exit_code is None:
            ev.proc.kill()

    def stop(self, ev: ProcessExitEvent,
             grace_s: float = DEFAULT_GRACE_S) -> None:
        """Graceful stop with escalation: SIGTERM now; if the child is
        still alive after `grace_s` a clock timer SIGKILLs it.  Unlike
        cancel(), on_exit still fires (callers observe the exit code) —
        this is how a fleet harness rolls a node without orphaning it.
        grace_s=0 escalates immediately."""
        if ev in self._pending:
            # never started: report the stop as an exit so callers
            # waiting on on_exit (the documented contract) still wake
            self._pending.remove(ev)
            ev.exit_code = -1
            self.clock.post_action(lambda ev=ev: ev.on_exit(-1),
                                   name="process-exit")
            return
        if ev.proc is None or ev.exit_code is not None:
            return
        if grace_s <= 0:
            ev.proc.kill()
            return
        try:
            ev.proc.send_signal(signal.SIGTERM)
        except OSError:
            return   # already gone; the pump reaps it
        from .clock import VirtualTimer
        timer = VirtualTimer(self.clock)
        ev._kill_timer = timer   # pin: a collected timer never fires

        def escalate() -> None:
            if ev.proc is not None and ev.exit_code is None \
                    and ev.proc.poll() is None:
                log.warning("process ignored SIGTERM for %.1fs; killing: %s",
                            grace_s, ev.cmdline)
                ev.proc.kill()

        timer.expires_from_now(grace_s, escalate)

    def _maybe_start(self) -> None:
        while (not self._shutdown and self._pending
               and len(self._running) < self.max_concurrent):
            ev = self._pending.popleft()
            try:
                out = subprocess.DEVNULL
                if ev.output_path is not None:
                    ev._out_fh = open(ev.output_path, "ab")
                    out = ev._out_fh
                ev.proc = subprocess.Popen(
                    shlex.split(ev.cmdline),
                    stdout=out,
                    stderr=subprocess.STDOUT if ev.output_path is not None
                    else subprocess.DEVNULL)
            except OSError as e:
                log.warning("spawn failed: %s (%s)", ev.cmdline, e)
                ev._close_output()
                ev.exit_code = 127
                self.clock.post_action(lambda ev=ev: ev.on_exit(127),
                                       name="process-exit")
                continue
            self._running.append(ev)

    def _pump(self) -> int:
        progressed = 0
        for ev in list(self._running):
            code = ev.proc.poll()
            if code is None:
                continue
            ev.exit_code = code
            ev._close_output()
            if ev._kill_timer is not None:
                ev._kill_timer.cancel()
                ev._kill_timer = None
            self._running.remove(ev)
            progressed += 1
            if not ev.cancelled:
                self.clock.post_action(lambda ev=ev, c=code: ev.on_exit(c),
                                       name="process-exit")
        if progressed:
            self._maybe_start()
        return progressed

    def shutdown(self, grace_s: float = 0.0) -> None:
        """Stop everything (reference: ProcessManagerImpl::shutdown).
        grace_s=0 keeps the historical hard-kill semantics; with a grace
        period every running child first gets SIGTERM, the whole set is
        polled for up to `grace_s`, and only the survivors are SIGKILLed —
        fleet teardown never leaks orphan nodes either way, but graceful
        children (flushing databases, closing sockets) get to exit 0."""
        self._shutdown = True
        self.clock.remove_io_pump(self._pump)
        for ev in self._pending:
            ev.exit_code = -1
        self._pending.clear()
        alive = [ev for ev in self._running
                 if ev.proc is not None and ev.exit_code is None]
        if grace_s > 0 and alive:
            for ev in alive:
                try:
                    ev.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
            deadline = monotonic_now() + grace_s
            while monotonic_now() < deadline \
                    and any(ev.proc.poll() is None for ev in alive):
                _time.sleep(0.02)
        for ev in self._running:
            if ev.proc is not None and ev.exit_code is None:
                if ev.proc.poll() is None:
                    ev.proc.kill()
                ev.proc.wait()
                ev.exit_code = ev.proc.returncode
            ev._close_output()
        self._running.clear()

    @property
    def num_running(self) -> int:
        return len(self._running)
