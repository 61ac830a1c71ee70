"""Runtime deterministic-context guard: fail-stop on nondeterminism.

The determinism lint rules (lint/rules/determinism.py) prove consensus
*source* never reaches for wall-clock, unseeded RNG or hash-ordered
primitives; this module proves the same property *dynamically*, in the
racetrace/lockorder tradition (static rule + runtime sanitizer + a
differential tier).  Consensus entry points arm a guarded region::

    with detguard.region("ledger-close"):
        ...  # close path

and while any region is active on the current thread, the guarded
primitives — ``time.time``/``time.monotonic`` (and the ``_ns`` twins),
``os.urandom``, every module-level ``random.*`` draw, and builtin
``hash()`` on str/bytes (the primitive that makes set iteration
PYTHONHASHSEED-sensitive) — fail-stop with a flight event and a crash
bundle (same discipline as ``DataRaceError``) instead of silently
forking the replicated state machine.

Zero overhead while disarmed: ``region()`` is a cheap no-op and no
primitive is patched.  Arm with ``STPU_DETGUARD=1`` in the environment
at import (how the hash-seed differential harness runs campaigns, see
simulation/hashseed_diff.py) or ``enable()`` in-process.

Attribution: the wrappers resolve the *caller* frame.  Only calls from
``stellar_core_tpu_torch`` code trip — stdlib infrastructure (threading,
queue, logging's LogRecord timestamps) schedules with monotonic time
without producing protocol-visible values — and the repo's own
observability plane (util/clock, util/perf, util/metrics, tracing,
eventlog, sampleprof, slo) plus the process-local bucket page filter
(bucket/index, reasoned hash-order suppression) are allowlisted for the
same reason.  Seeded ``random.Random`` *instances* are untouched: their
methods do not route through the patched module-level functions, which
is exactly the injected-RNG shape rng-discipline mandates.
"""

from __future__ import annotations

import builtins
import os
import random
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

_armed = False
_tls = threading.local()
# counters only; a raw lock keeps the guard invisible to the traced-lock
# machinery it may run inside of
_stats_mu = threading.Lock()  # corelint: disable=raw-lock -- guard internals must stay invisible to lockorder's held stack
_stats = {"regions": 0, "trips": 0}
# (module, attr) -> original callable, populated by enable()
_originals: Dict[Tuple[int, str], Tuple[object, str, object]] = {}

# only calls originating from these path fragments trip (repo code, not
# stdlib scheduling); tests widen this to exercise the fail-stop
_TRIPPING_ROOTS = ("stellar_core_tpu_torch",)
# caller paths allowed to touch guarded primitives inside a region
_EXEMPT_CALLERS = (
    "util/clock", "util/perf", "util/tracing", "util/metrics",
    "util/eventlog", "util/sampleprof", "util/slo", "util/logging",
    "util/detguard", "bucket/index",
)


class DeterminismError(AssertionError):
    """A guarded region touched a nondeterministic primitive."""


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------

@contextmanager
def region(name: str):
    """Mark the dynamic extent of a consensus computation.  No-op while
    the guard is disarmed; nestable (soroban-apply inside ledger-close)."""
    if not _armed:
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(name)
    with _stats_mu:
        _stats["regions"] += 1
    try:
        yield
    finally:
        stack.pop()


def current_region() -> Optional[str]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def stats() -> dict:
    with _stats_mu:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_mu:
        _stats["regions"] = 0
        _stats["trips"] = 0


# ---------------------------------------------------------------------------
# the tripwire
# ---------------------------------------------------------------------------

def _caller_trips() -> bool:
    """True when the frame that called the patched primitive is repo
    consensus code (not stdlib scheduling, not the observability plane)."""
    try:
        fn = sys._getframe(2).f_code.co_filename.replace(os.sep, "/")
    except ValueError:
        return False
    if not any(r in fn for r in _TRIPPING_ROOTS):
        return False
    return not any(s in fn for s in _EXEMPT_CALLERS)


def _trip(primitive: str) -> None:
    if getattr(_tls, "busy", False):
        return  # reporting plumbing is the guard's own, not the program's
    _tls.busy = True
    try:
        reg = current_region()
        stack = "".join(traceback.format_stack(limit=12)[:-2])
        msg = (f"nondeterministic primitive {primitive} inside guarded "
               f"region '{reg}' — consensus code must use VirtualClock / "
               f"an injected seeded Random / sorted iteration")
        with _stats_mu:
            _stats["trips"] += 1
        try:
            from . import eventlog
            eventlog.record("Process", "ERROR",
                            "determinism guard tripped",
                            region=reg, primitive=primitive,
                            caller_stack=stack)
            eventlog.write_crash_bundle(f"DeterminismError: {msg}")
        except Exception:  # corelint: disable=exception-hygiene -- the fail-stop below must never be masked by dump plumbing
            pass
        raise DeterminismError(msg)
    finally:
        _tls.busy = False


def _guard(orig, primitive: str, only_types: Optional[tuple] = None):
    def wrapper(*args, **kwargs):
        if _armed and getattr(_tls, "stack", None) \
                and (only_types is None
                     or (args and isinstance(args[0], only_types))) \
                and _caller_trips():
            _trip(primitive)
        return orig(*args, **kwargs)
    wrapper.__wrapped__ = orig
    wrapper.__name__ = getattr(orig, "__name__", primitive)
    return wrapper


def _targets():
    out = [
        (time, "time", "time.time", None),
        (time, "time_ns", "time.time_ns", None),
        (time, "monotonic", "time.monotonic", None),
        (time, "monotonic_ns", "time.monotonic_ns", None),
        (os, "urandom", "os.urandom", None),
        (builtins, "hash", "builtin hash() on str/bytes", (str, bytes)),
    ]
    for fname in ("random", "randint", "randrange", "choice", "choices",
                  "shuffle", "sample", "uniform", "getrandbits",
                  "randbytes", "seed"):
        if hasattr(random, fname):
            out.append((random, fname, f"random.{fname}", None))
    return out


def enable() -> None:
    """Patch the guarded primitives.  Idempotent; regions armed from now
    on.  Seeded random.Random instances keep their unpatched methods."""
    global _armed
    if _armed:
        return
    for mod, attr, primitive, only in _targets():
        orig = getattr(mod, attr)
        _originals[(id(mod), attr)] = (mod, attr, orig)
        setattr(mod, attr, _guard(orig, primitive, only))
    _armed = True


def disable() -> None:
    """Restore every patched primitive."""
    global _armed
    _armed = False
    for mod, attr, orig in list(_originals.values()):
        setattr(mod, attr, orig)
    _originals.clear()


def enabled() -> bool:
    return _armed


if os.environ.get("STPU_DETGUARD"):
    enable()
