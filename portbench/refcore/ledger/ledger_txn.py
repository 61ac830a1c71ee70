"""LedgerTxn: nested transactional read/write cache over ledger entries.

Reference: src/ledger/LedgerTxn.{h,cpp} — AbstractLedgerTxn, LedgerTxn,
LedgerTxnRoot(Impl), LedgerTxnHeader.  Semantics kept: nested txns see
parent state through a copy-on-write delta; commit folds the delta into the
parent, rollback discards it; at most one active child; header mutations are
transactional alongside entries.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..xdr import (LedgerEntry, LedgerHeader, LedgerKey, deep_copy_value,
                   ledger_entry_key, ledger_entry_key_xdr)


class LedgerTxnError(Exception):
    pass


class AbstractLedgerTxnParent:
    def get_entry(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        raise NotImplementedError

    def get_header(self) -> LedgerHeader:
        raise NotImplementedError

    def _attach_child(self, child: "LedgerTxn") -> None:
        raise NotImplementedError

    def _detach_child(self) -> None:
        raise NotImplementedError

    def all_keys(self) -> Iterator[bytes]:
        raise NotImplementedError


class LedgerTxnRoot(AbstractLedgerTxnParent):
    """Authoritative live-entry store (a dict, in memory) + last closed
    header."""

    def __init__(self, header: LedgerHeader):
        self._header = header
        self._child: Optional[LedgerTxn] = None
        self._entries: Dict[bytes, LedgerEntry] = {}

    # -- parent protocol ----------------------------------------------------
    def get_entry(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        return self._entries.get(key_bytes)

    def get_header(self) -> LedgerHeader:
        return self._header

    def _attach_child(self, child: "LedgerTxn") -> None:
        if self._child is not None:
            raise LedgerTxnError("LedgerTxnRoot already has an active child")
        self._child = child

    def _detach_child(self) -> None:
        self._child = None

    def all_keys(self) -> Iterator[bytes]:
        return iter(list(self._entries.keys()))

    # -- root-only ----------------------------------------------------------
    def _apply_delta(self, entries: Dict[bytes, Optional[LedgerEntry]],
                     header: Optional[LedgerHeader]) -> None:
        for k, e in entries.items():
            if e is None:
                self._entries.pop(k, None)
            else:
                self._entries[k] = e
        if header is not None:
            self._header = header


class LedgerTxn(AbstractLedgerTxnParent):
    """One nesting level.  Use as a context manager or call commit/rollback
    explicitly; falling out of scope without commit == rollback (matches the
    reference's destructor behavior)."""

    def __init__(self, parent: AbstractLedgerTxnParent):
        self._parent = parent
        self._delta: Dict[bytes, Optional[LedgerEntry]] = {}
        self._header: Optional[LedgerHeader] = None
        self._child: Optional[LedgerTxn] = None
        self._open = True
        parent._attach_child(self)

    # -- context manager ----------------------------------------------------
    def __enter__(self) -> "LedgerTxn":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._open:
            self.rollback()

    # -- parent protocol (for nested children; no seal check — the child
    #    delegates reads through its sealed ancestors by design) ------------
    def get_entry(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        if not self._open:
            raise LedgerTxnError("LedgerTxn is closed")
        if key_bytes in self._delta:
            return self._delta[key_bytes]
        return self._parent.get_entry(key_bytes)

    def get_header(self) -> LedgerHeader:
        if self._header is not None:
            return self._header
        return self._parent.get_header()

    def _attach_child(self, child: "LedgerTxn") -> None:
        if self._child is not None:
            raise LedgerTxnError("LedgerTxn already has an active child")
        self._child = child

    def _detach_child(self) -> None:
        self._child = None

    def all_keys(self) -> Iterator[bytes]:
        seen = set()
        for k in self._parent.all_keys():
            seen.add(k)
        for k, v in self._delta.items():
            if v is None:
                seen.discard(k)
            else:
                seen.add(k)
        return iter(seen)

    # -- entry operations ----------------------------------------------------
    def load(self, key: LedgerKey) -> Optional[LedgerEntry]:
        """Copy-out load (deep — struct .copy() is shallow); mutate the
        copy then put() it back."""
        return self.load_by_bytes(key.to_xdr())

    def load_by_bytes(self, key_bytes: bytes) -> Optional[LedgerEntry]:
        """load() for callers that already hold the key's XDR bytes (the
        account hot path memoizes them — xdr.account_key_xdr)."""
        self._assert_open_no_child()
        e = self.get_entry(key_bytes)
        # deep_copy_value dispatches straight to the native copier,
        # skipping the per-entry Python method wrapper (hot path)
        return deep_copy_value(e) if e is not None else None

    def exists(self, key: LedgerKey) -> bool:
        self._assert_open_no_child()
        return self.get_entry(key.to_xdr()) is not None

    def create(self, entry: LedgerEntry) -> None:
        self._assert_open_no_child()
        kb = ledger_entry_key_xdr(entry)
        if self.get_entry(kb) is not None:
            raise LedgerTxnError("create: entry already exists")
        self._delta[kb] = entry

    def put(self, entry: LedgerEntry) -> None:
        """Create-or-update (reference: LedgerTxn::createWithoutLoading /
        updateWithoutLoading pair)."""
        self._assert_open_no_child()
        self._delta[ledger_entry_key_xdr(entry)] = entry

    def update(self, entry: LedgerEntry) -> None:
        self._assert_open_no_child()
        kb = ledger_entry_key_xdr(entry)
        if self.get_entry(kb) is None:
            raise LedgerTxnError("update: entry does not exist")
        self._delta[kb] = entry

    def erase(self, key: LedgerKey) -> None:
        self._assert_open_no_child()
        kb = key.to_xdr()
        if self.get_entry(kb) is None:
            raise LedgerTxnError("erase: entry does not exist")
        self._delta[kb] = None

    # -- header operations ---------------------------------------------------
    def load_header(self) -> LedgerHeader:
        """Copy-out header; mutate and commit_header() it."""
        self._assert_open_no_child()
        return self.get_header().copy()

    def commit_header(self, header: LedgerHeader) -> None:
        self._assert_open_no_child()
        self._header = header

    # -- lifecycle -----------------------------------------------------------
    def commit(self) -> None:
        self._assert_open_no_child()
        parent = self._parent
        if isinstance(parent, LedgerTxn):
            parent._delta.update(self._delta)
            if self._header is not None:
                parent._header = self._header
        else:
            parent._apply_delta(self._delta, self._header)
        self._finish()

    def rollback(self) -> None:
        if not self._open:
            return  # idempotent; must NOT detach a sibling's registration
        if self._child is not None:
            self._child.rollback()
        self._finish()

    def _finish(self) -> None:
        assert self._open, "LedgerTxn finished twice"
        self._open = False
        self._parent._detach_child()
        self._delta = {}
        self._header = None

    def _assert_open_no_child(self) -> None:
        if not self._open:
            raise LedgerTxnError("LedgerTxn is closed")
        if self._child is not None:
            raise LedgerTxnError("LedgerTxn has an active child (sealed)")

    # -- delta inspection (LedgerManager uses this to feed the bucket list
    #    and emit meta; reference: LedgerTxn::getChanges / getDelta) --------
    def delta(self) -> Dict[bytes, Optional[LedgerEntry]]:
        return dict(self._delta)
