"""Always-on sampling profiler: periodic thread-stack sampling into
per-subsystem self-time buckets and folded flamegraph stacks.

Reference shape: the reference ships LogSlowExecution + medida timers —
aggregate latencies with no attribution of where wall time actually
went.  This module answers "which subsystem is this node burning CPU
in" continuously and cheaply enough to leave on for a whole soak:

- a daemon thread wakes ~67 times/second (``STPU_SAMPLEPROF_HZ``) and
  snapshots every thread's Python stack via ``sys._current_frames()`` —
  no signals (SIGPROF only reaches the main thread and is unusable
  under embedded interpreters), no per-call instrumentation;
- each sample attributes the LEAF frame's module path to a subsystem
  bucket (``stellar_core_tpu_torch/<pkg>/...`` → ``<pkg>``; everything else →
  ``other``) — self-time, not cumulative, so the buckets sum to the
  sampled wall time;
- whole stacks aggregate into bounded folded-stack counts
  (``a;b;c <n>`` — feed to any flamegraph renderer).

Exported at the ``/profile`` admin endpoint; the folded stacks ride
along in every crash bundle (a registered util/eventlog bundle source)
so a post-mortem shows where the node was spending CPU when it died.
``STPU_SAMPLEPROF=1`` starts the profiler at Application startup;
its overhead is measured by the reference package's replay microbench
(bench.py's ``sampleprof`` row).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional

from .lockorder import make_lock
from .metrics import registry as _registry

DEFAULT_HZ = 67.0          # deliberately co-prime-ish with 10ms timers
MAX_STACK_DEPTH = 48       # frames kept per folded stack
MAX_FOLDED_STACKS = 2000   # unique stacks kept; overflow → dropped


def _subsystem_of(filename: str) -> str:
    """Map a code object's file path to its bucket: the package directly
    under stellar_core_tpu_torch/ (util, herder, ledger, catchup, overlay,
    bucket, history, main, simulation, ...); anything outside the tree
    (stdlib, site-packages, test files) is ``other``."""
    parts = filename.replace("\\", "/").split("/")
    try:
        i = len(parts) - 1 - parts[::-1].index("stellar_core_tpu_torch")
    except ValueError:
        return "other"
    if i + 1 >= len(parts):
        return "other"
    nxt = parts[i + 1]
    return nxt[:-3] if nxt.endswith(".py") else nxt


class SamplingProfiler:
    """The process sampler.  start()/stop() are idempotent; all mutable
    state is guarded by one leaf lock (the sampler thread writes, admin
    /profile + crash bundles read)."""

    def __init__(self, hz: float = DEFAULT_HZ):
        self.hz = float(hz)
        self._lock = make_lock("sampleprof.state")
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._samples = 0
        self._dropped = 0
        self._subsystems: Dict[str, int] = {}
        self._folded: Dict[str, int] = {}
        # per-sample fast paths: filename -> subsystem memo (stacks
        # resample the same code objects thousands of times) and the
        # counter pair, re-resolved when tests swap the registry
        self._sub_cache: Dict[str, str] = {}
        self._counters = (None, None, None)  # (registry, samples, dropped)
        reg = _registry()
        reg.counter("profile.sampler.samples")
        reg.counter("profile.sampler.dropped")
        reg.weak_gauge("profile.sampler.running", self,
                       lambda p: 1.0 if p.running() else 0.0)

    def _counter_pair(self):
        reg = _registry()
        cached_reg, c_samples, c_dropped = self._counters
        if cached_reg is not reg:
            c_samples = reg.counter("profile.sampler.samples")
            c_dropped = reg.counter("profile.sampler.dropped")
            self._counters = (reg, c_samples, c_dropped)
        return c_samples, c_dropped

    # -- lifecycle ----------------------------------------------------------
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def start(self) -> bool:
        """Start sampling; returns True if a new sampler thread was
        started, False if one was already running (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="sampleprof", daemon=True)
            self._thread.start()
        from . import eventlog
        eventlog.register_bundle_source("profile", self.bundle)
        return True

    def stop(self) -> bool:
        """Stop sampling; returns True if a running sampler was stopped
        (idempotent — stopping a stopped profiler is a no-op)."""
        with self._lock:
            t = self._thread
            if t is None:
                return False
            self._stop_evt.set()
            self._thread = None
        t.join(timeout=2.0)
        from . import eventlog
        eventlog.unregister_bundle_source("profile")
        return True

    # -- sampling loop ------------------------------------------------------
    def _run(self) -> None:
        interval = 1.0 / self.hz
        own = threading.get_ident()
        with self._lock:
            evt = self._stop_evt
        while not evt.wait(interval):
            self._sample_once(own)

    def _sample_once(self, skip_tid: int) -> None:
        frames = sys._current_frames()
        dropped = 0
        with self._lock:
            c_samples, c_dropped = self._counter_pair()
            sub_cache = self._sub_cache
            for tid, frame in frames.items():
                if tid == skip_tid:
                    continue
                # leaf-frame self-time bucket (filename memoized — stacks
                # resample the same code objects thousands of times)
                fn = frame.f_code.co_filename
                sub = sub_cache.get(fn)
                if sub is None:
                    sub = _subsystem_of(fn)
                    if len(sub_cache) < 4096:
                        sub_cache[fn] = sub
                self._subsystems[sub] = self._subsystems.get(sub, 0) + 1
                self._samples += 1
                # folded stack, root-first
                names: List[str] = []
                f = frame
                depth = 0
                while f is not None and depth < MAX_STACK_DEPTH:
                    names.append(f.f_code.co_name)
                    f = f.f_back
                    depth += 1
                folded = ";".join(reversed(names))
                if folded in self._folded:
                    self._folded[folded] += 1
                elif len(self._folded) < MAX_FOLDED_STACKS:
                    self._folded[folded] = 1
                else:
                    self._dropped += 1
                    dropped += 1
        n = len(frames) - (1 if skip_tid in frames else 0)
        if n > 0:
            c_samples.inc(n)
        if dropped:
            c_dropped.inc(dropped)

    # -- readers ------------------------------------------------------------
    def snapshot(self) -> dict:
        """The /profile document: per-subsystem self-time (sample counts
        and estimated seconds at the configured rate) plus the heaviest
        folded stacks."""
        with self._lock:
            samples = self._samples
            dropped = self._dropped
            subs = dict(self._subsystems)
            top = sorted(self._folded.items(),
                         key=lambda kv: -kv[1])[:50]
        return {
            "running": self.running(),
            "hz": self.hz,
            "samples": samples,
            "dropped_stacks": dropped,
            "subsystems": {
                name: {"samples": n,
                       "self_s": round(n / self.hz, 3)}
                for name, n in sorted(subs.items(),
                                      key=lambda kv: -kv[1])},
            "top_stacks": [{"stack": s, "count": c} for s, c in top],
        }

    def folded(self) -> str:
        """Folded-stack dump, one ``frame;frame;frame count`` line each —
        the flamegraph.pl / speedscope input format."""
        with self._lock:
            items = sorted(self._folded.items())
        return "\n".join(f"{stack} {count}" for stack, count in items)

    def bundle(self) -> dict:
        """Crash-bundle source: compact profile + folded stacks."""
        snap = self.snapshot()
        return {"hz": snap["hz"], "samples": snap["samples"],
                "subsystems": snap["subsystems"],
                "folded": self.folded()}

    def reset(self) -> None:
        with self._lock:
            self._samples = 0
            self._dropped = 0
            self._subsystems.clear()
            self._folded.clear()


_profiler: Optional[SamplingProfiler] = None
_profiler_lock = make_lock("sampleprof.singleton")


def profiler() -> SamplingProfiler:
    """The process-wide sampler (created on first use, stopped)."""
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            hz = float(os.environ.get("STPU_SAMPLEPROF_HZ", DEFAULT_HZ))
            _profiler = SamplingProfiler(hz=hz)
        return _profiler


def start_if_configured() -> bool:
    """``STPU_SAMPLEPROF=1`` (or any truthy value) starts the sampler —
    called from Application startup; safe to call repeatedly."""
    flag = os.environ.get("STPU_SAMPLEPROF", "")
    if flag.lower() in ("", "0", "false", "off", "no"):
        return False
    return profiler().start()
