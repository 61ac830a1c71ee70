"""Runtime lock-order tracer: record the real acquisition DAG, fail-stop
on inversion.

The static side (corelint's lock-order rule) proves the *lexical*
acquisition graph acyclic; this module is the runtime complement for the
orders statics can't see (callbacks, cross-module paths).  The five
lock-bearing modules (bucket/manager, bucket/snapshot, util/metrics,
util/tracing, crypto/keys) create their locks through `make_lock` /
`make_rlock` with a lock-class name; with tracing OFF (the default) the
factory returns a plain `threading.Lock` — zero per-acquisition
overhead.  With tracing ON (`STPU_LOCK_TRACE=1` in the environment at
lock-creation time, or `enable()` before the subsystem is built) each
acquisition records held->acquired edges into a process-global graph and
raises `LockOrderError` BEFORE acquiring if the new edge would close a
cycle — turning a potential ABBA deadlock into an immediate, attributed
failure (reference shape: the invariant fail-stop discipline).

Identity is the lock *class* (the name passed to the factory), not the
instance: all `metrics.histogram` locks are one node, which is the
granularity deadlock analysis needs.  Re-acquiring the same class while
holding it is tolerated for RLocks and self-edges are never recorded.
The tracer assumes each acquisition is released by the acquiring thread
(true for all `with`-scoped usage, which is the only form in this
tree): a cross-thread release — legal for a bare `threading.Lock` —
would leave a stale held-stack entry on the acquiring thread and skew
its subsequent edges.

Overhead when enabled: one thread-local list append + a dict probe per
acquisition, and a DFS over the (tiny) class graph only when a NEW edge
appears.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Set, Tuple

# STPU_RACE_TRACE implies lock tracing: the race sanitizer
# (util/racetrace.py) computes per-field locksets from this module's
# thread-local held stack, which only fills when locks are traced
_enabled = bool(os.environ.get("STPU_LOCK_TRACE")) \
    or bool(os.environ.get("STPU_RACE_TRACE"))
_graph_mu = threading.Lock()
# observed acquisition edges: held-class -> set of acquired-classes
_edges: Dict[str, Set[str]] = {}
_tls = threading.local()


class LockOrderError(AssertionError):
    """A lock acquisition inverted the observed acquisition DAG."""


def _fail_lock_order(msg: str) -> None:
    """Fail-stop with a post-mortem: record the inversion as a flight
    event and write a crash bundle (util/eventlog → $STPU_CRASH_DIR)
    before raising.  Called with NO locks held (the caller releases
    _graph_mu first) so bundle assembly — which snapshots metrics and the
    event ring under their own locks — cannot add edges to the graph
    being reported on, let alone deadlock against it."""
    try:
        from . import eventlog
        eventlog.record("Process", "ERROR", "lock-order inversion",
                        detail=msg)
        eventlog.write_crash_bundle(f"LockOrderError: {msg}")
    except Exception:  # corelint: disable=exception-hygiene -- the fail-stop below must never be masked by dump plumbing
        pass
    raise LockOrderError(msg)


def enable() -> None:
    """Trace locks created from now on (locks made before stay plain)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def make_lock(name: str) -> "threading.Lock":
    """A `threading.Lock`, traced under `name` when tracing is enabled."""
    lock = threading.Lock()
    return _TracedLock(lock, name) if _enabled else lock


def make_rlock(name: str) -> "threading.RLock":
    lock = threading.RLock()
    return _TracedLock(lock, name, reentrant=True) if _enabled else lock


def observed_edges() -> Dict[str, Set[str]]:
    """Copy of the acquisition DAG recorded so far."""
    with _graph_mu:
        return {k: set(v) for k, v in _edges.items()}


def reset_observed() -> None:
    with _graph_mu:
        _edges.clear()


def held_locks() -> Tuple[str, ...]:
    """Lock classes the CALLING thread currently holds, innermost last
    (reentrant re-acquisitions appear once per acquire).  The race
    sanitizer's lockset source; empty when tracing is off or the thread
    holds only untraced locks."""
    return tuple(_held_stack())


def _held_stack() -> List[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _would_cycle(src: str, dst: str) -> List[str]:
    """Path dst ~> src in the edge graph (so adding src->dst closes a
    cycle), or [] — caller holds _graph_mu."""
    path = [dst]
    seen = {dst}

    def dfs(u: str) -> bool:
        if u == src:
            return True
        for v in _edges.get(u, ()):
            if v not in seen:
                seen.add(v)
                path.append(v)
                if dfs(v):
                    return True
                path.pop()
        return False

    return path if dfs(dst) else []


class _TracedLock:
    """Lock proxy recording acquisition order by lock class."""

    __slots__ = ("_lock", "name", "_reentrant")

    def __init__(self, lock, name: str, reentrant: bool = False):
        self._lock = lock
        self.name = name
        self._reentrant = reentrant

    def _before_acquire(self) -> None:
        held = _held_stack()
        if not held:
            return
        if self.name in held:
            if self._reentrant:
                return  # same-class re-entry: no edge, no inversion
            _fail_lock_order(
                f"non-reentrant lock class '{self.name}' re-acquired "
                f"while already held (held: {held})")
        new_edges: List[Tuple[str, str]] = []
        inversion = None
        with _graph_mu:
            for h in held:
                if self.name not in _edges.get(h, ()):
                    cyc = _would_cycle(h, self.name)
                    if cyc:
                        inversion = (
                            f"lock-order inversion: acquiring "
                            f"'{self.name}' while holding '{h}', but the "
                            f"observed DAG already orders "
                            f"{' -> '.join(cyc)}")
                        break
                    new_edges.append((h, self.name))
            if inversion is None:
                for h, n in new_edges:
                    _edges.setdefault(h, set()).add(n)
        if inversion is not None:
            # raised OUTSIDE _graph_mu: the crash-bundle dump acquires
            # other (traced) locks and must not nest under the graph lock
            _fail_lock_order(inversion)

    def acquire(self, *a, **kw) -> bool:
        self._before_acquire()
        got = self._lock.acquire(*a, **kw)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        stack = _held_stack()
        # remove the innermost matching frame (not necessarily the top:
        # out-of-order releases are legal for locks)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        # deliberate delegation with no fallback: a traced lock exposes
        # exactly the wrapped lock's API (RLock grows .locked() only in
        # Python 3.14) — tracing must not change what code can call
        return self._lock.locked()
