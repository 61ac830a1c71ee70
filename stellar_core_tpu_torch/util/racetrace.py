"""Runtime data-race sanitizer: Eraser-style per-field locksets.

The lock-order tracer (util/lockorder.py) proves the locks we DO take are
taken in a consistent order; this module proves shared fields are covered
by a lock at all.  Classes opt in with the ``@race_checked`` decorator —
zero overhead while tracing is off (the decorator returns the class
unchanged; same contract as ``make_lock``).  With tracing ON
(``STPU_RACE_TRACE=1`` in the environment at import, or ``enable()``
before the subsystem is built) every registered class's attribute access
is instrumented and each instance field runs the classic Eraser state
machine [Savage et al., SOSP '97]:

  Virgin --first access--> Exclusive(owner thread)
  Exclusive --access by 2nd thread--> Shared (read) / SharedMod (write),
           candidate lockset := locks the 2nd thread holds
  Shared/SharedMod: lockset := lockset INTERSECT locks held at the access
           (a write promotes Shared -> SharedMod)

The Exclusive state gives the init-then-publish pattern a free pass: a
field hammered by its creating thread carries no lockset obligation until
a second thread actually touches it.  A WRITE from a non-owner thread
that leaves the candidate lockset EMPTY is a data race: the access raises
``DataRaceError`` after flight-recording the event and writing a crash
bundle naming the field, both threads, and the shrinking lockset history
(util/eventlog -> $STPU_CRASH_DIR).  First-owner writes with concurrent
readers are deliberately not fail-stopped: the repo's GIL-atomic
monitoring reads (gauge callbacks, /metrics snapshots from the admin
threads) are exactly that shape — they surface in the lockset history,
not as crashes.

Granularity: the proxy sees BINDING accesses (``obj.field`` get/set),
not memory accesses — an in-place container mutation from a second
thread (``obj.d[k] = v``, ``obj.l.append(x)``) registers as a *read* of
the binding and therefore refines the lockset without fail-stopping.
That shape is the static rule's job: corelint's `thread-safety` counts
subscript stores and mutator-method calls through a field as writes, so
the two layers cover each other's blind spots.

Locksets come from lockorder's thread-local held stack, so the sanitizer
only sees locks created through ``make_lock``/``make_rlock`` — which the
``raw-lock`` lint rule makes all of them.  ``STPU_RACE_TRACE=1`` implies
lock tracing (lockorder checks both variables); in-process ``enable()``
calls ``lockorder.enable()`` itself, and must run BEFORE the subsystems
under test create their locks, or every lockset reads empty.

Overhead when enabled: one dict probe + set intersection per tracked
attribute access on registered classes; exactly zero when off.
"""

from __future__ import annotations

import os
import threading
import traceback
import types
from collections import deque
from typing import Dict, Optional, Tuple

from . import lockorder

_enabled = bool(os.environ.get("STPU_RACE_TRACE"))
# bumped by every enable(): field state from an earlier tracing session
# is stale (ownership may have legitimately moved while tracing was off)
# and is re-owned on first access instead of raising a false positive
_epoch = 1
# serializes the per-field state machine: two second-threads arriving
# concurrently must INTERSECT their locksets, not overwrite each other's.
# Deliberately a RAW lock, not make_lock: a traced lock acquired inside
# _on_access would push onto the held stack mid-access and pollute every
# candidate lockset with itself.
_state_mu = threading.Lock()  # corelint: disable=raw-lock -- must stay invisible to the held stack it samples
# classes that asked for instrumentation: cls -> ignore frozenset
_registered: Dict[type, frozenset] = {}
# instrumented classes -> (prev __setattr__, prev __getattribute__) from
# cls.__dict__ (None = inherited, restore by deletion)
_instrumented: Dict[type, Tuple[Optional[object], Optional[object]]] = {}
_tls = threading.local()

_HISTORY_CAP = 16        # lockset-history entries kept per field
_STATE_ATTR = "_race_fields_"

_EXCLUSIVE, _SHARED, _SHARED_MOD = "exclusive", "shared", "shared-modified"


class DataRaceError(AssertionError):
    """A second thread wrote a field whose candidate lockset is empty."""


class _FieldState:
    __slots__ = ("state", "owner_ident", "owner_name", "lockset",
                 "history", "reported", "epoch")

    def __init__(self, owner_ident: int, owner_name: str, epoch: int):
        self.state = _EXCLUSIVE
        self.owner_ident = owner_ident
        self.owner_name = owner_name
        self.lockset: Optional[set] = None   # None until first 2nd-thread access
        # newest-first post-mortem: the racing access itself must be in
        # the bundle, so the deque evicts the OLDEST entries
        self.history: deque = deque(maxlen=_HISTORY_CAP)
        self.reported = False
        self.epoch = epoch


def enable() -> None:
    """Instrument every registered class from now on.  Call BEFORE the
    code under test creates its locks/objects (same ordering contract as
    lockorder.enable).  Starts a fresh epoch: field state tracked by an
    earlier enable() is re-owned on first access, because ownership may
    have legitimately moved while tracing was off."""
    global _enabled, _epoch
    _epoch += 1
    _enabled = True
    lockorder.enable()
    for cls in list(_registered):
        _instrument(cls)


def disable() -> None:
    """De-instrument every class.  Per-instance field state is left on
    the instances but carries the old epoch, so a later enable() re-owns
    it instead of trusting stale ownership."""
    global _enabled
    _enabled = False
    for cls in list(_instrumented):
        _deinstrument(cls)


def enabled() -> bool:
    return _enabled


def race_checked(cls: Optional[type] = None, *, ignore: Tuple[str, ...] = ()):
    """Class decorator opting into the race sanitizer.

    ``ignore`` names fields excluded from tracking (use sparingly, with
    the static ``# corelint: owned-by=`` annotation carrying the reason).
    With tracing off this returns ``cls`` unchanged — zero overhead.
    A ``__slots__`` class must list ``_race_fields_`` in its slots, or
    its fields silently go untracked (nowhere to hang the state).
    """
    def wrap(c: type) -> type:
        _registered[c] = frozenset(ignore)
        if _enabled:
            _instrument(c)
        return c
    return wrap if cls is None else wrap(cls)


# ---------------------------------------------------------------------------
# instrumentation
# ---------------------------------------------------------------------------

def _instrument(cls: type) -> None:
    if cls in _instrumented:
        return
    _instrumented[cls] = (cls.__dict__.get("__setattr__"),
                          cls.__dict__.get("__getattribute__"))
    base_set = cls.__setattr__      # resolved through the MRO, pre-wrap
    base_get = cls.__getattribute__

    def __setattr__(self, name, value, _base=base_set):
        _on_access(self, name, True)
        _base(self, name, value)

    def __getattribute__(self, name, _base=base_get):
        value = _base(self, name)
        if name.startswith("_race") or name.startswith("__"):
            return value
        try:
            d = object.__getattribute__(self, "__dict__")
        except AttributeError:
            d = None                 # __slots__ class
        # instance fields only, never methods: dict membership for
        # ordinary classes, a member descriptor for __slots__ ones
        if (d is not None and name in d) or (
                d is None and isinstance(
                    getattr(type(self), name, None),
                    types.MemberDescriptorType)):
            _on_access(self, name, False)
        return value

    cls.__setattr__ = __setattr__
    cls.__getattribute__ = __getattribute__


def _deinstrument(cls: type) -> None:
    prev_set, prev_get = _instrumented.pop(cls)
    if prev_set is None:
        del cls.__setattr__
    else:
        cls.__setattr__ = prev_set
    if prev_get is None:
        del cls.__getattribute__
    else:
        cls.__getattribute__ = prev_get


# ---------------------------------------------------------------------------
# the lockset state machine
# ---------------------------------------------------------------------------

def _on_access(obj, name: str, is_write: bool) -> None:
    if not _enabled or name.startswith("__"):
        return
    if getattr(_tls, "busy", False):
        # re-entrancy latch: reporting/bundle assembly touches decorated
        # objects (the flight recorder IS one) — those accesses are the
        # sanitizer's own, not the program's
        return
    ignore = type(obj).__dict__.get("_race_ignore_cache_")
    if ignore is None:
        ignore = _ignore_for(type(obj))
    if name in ignore:
        return
    _tls.busy = True
    try:
        me = threading.get_ident()
        report = None
        # the state machine runs under _state_mu: concurrent second
        # threads must intersect locksets, not overwrite each other's
        # (held_locks() only reads a thread-local — safe under the mutex)
        with _state_mu:
            try:
                fields = object.__getattribute__(obj, _STATE_ATTR)
            except AttributeError:
                fields = {}
                try:
                    object.__setattr__(obj, _STATE_ATTR, fields)
                except AttributeError:
                    return           # __slots__ instance: nowhere to track
            st = fields.get(name)
            if st is None or st.epoch != _epoch:
                fields[name] = _FieldState(
                    me, threading.current_thread().name, _epoch)
                return
            if st.state == _EXCLUSIVE and st.owner_ident == me:
                return               # init-then-publish: no obligation yet
            held = lockorder.held_locks()
            if st.state == _EXCLUSIVE:
                # second thread arrived: the candidate lockset is born
                st.lockset = set(held)
                st.state = _SHARED_MOD if is_write else _SHARED
            else:
                st.lockset &= set(held)
                if is_write:
                    st.state = _SHARED_MOD
            st.history.append({
                "thread": threading.current_thread().name,
                "op": "write" if is_write else "read",
                "held": list(held),
                "lockset": sorted(st.lockset),
            })
            if is_write and st.owner_ident != me and not st.lockset \
                    and not st.reported:
                st.reported = True
                report = st
        if report is not None:
            # raised OUTSIDE _state_mu: bundle assembly walks decorated
            # objects and must not nest under the state lock
            _report(obj, name, report)
    finally:
        _tls.busy = False


def _ignore_for(cls: type) -> frozenset:
    """Union of every registered ancestor's ignore set, cached on the
    class (decorated subclasses of decorated classes compose)."""
    out = frozenset()
    for c in cls.__mro__:
        out |= _registered.get(c, frozenset())
    cls._race_ignore_cache_ = out
    return out


def _report(obj, name: str, st: _FieldState) -> None:
    """Fail-stop with a post-mortem: the race becomes a flight event and
    a crash bundle before the raise (the lock-order tracer's discipline —
    an attributed failure beats a corrupted queue)."""
    writer = threading.current_thread().name
    stack = "".join(traceback.format_stack(limit=12)[:-2])
    msg = (f"data race on {type(obj).__name__}.{name}: write from thread "
           f"'{writer}' with empty lockset (field first owned by "
           f"'{st.owner_name}'); lockset history: {list(st.history)}")
    try:
        from . import eventlog
        eventlog.record("Process", "ERROR", "data race detected",
                        field=f"{type(obj).__name__}.{name}",
                        writer=writer, owner=st.owner_name,
                        lockset_history=list(st.history),
                        writer_stack=stack)
        eventlog.write_crash_bundle(f"DataRaceError: {msg}")
    except Exception:  # corelint: disable=exception-hygiene -- the fail-stop below must never be masked by dump plumbing
        pass
    raise DataRaceError(msg)


def field_state(obj, name: str) -> Optional[dict]:
    """Introspection for tests/diagnostics: the field's current Eraser
    state, or None if never tracked."""
    try:
        st = object.__getattribute__(obj, _STATE_ATTR).get(name)
    except AttributeError:
        return None
    if st is None:
        return None
    return {"state": st.state, "owner": st.owner_name,
            "lockset": sorted(st.lockset) if st.lockset is not None
            else None,
            "history": list(st.history)}
