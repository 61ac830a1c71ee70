"""Faults planted in the port for the control and for the tests that show
a cell's comparison catches them.  Each is a context manager that patches
the port where its answer is produced and restores it on exit.

- control: the guarantee broken, every signature accepted: the card's
  verdicts (accel.ed25519.verify_batch_async) and the host's
  (crypto.sodium.verify_detached) all read valid, verified or not.
- answer_altered: the first verdict of every batch the card returns is
  flipped.
- half_left_out: the second half of every batch the card is given is not
  verified; its verdicts read valid.
- state_unchanged: every fourth ledger applies no transaction: the state
  it leaves is the state it found, but for the header.  On the Python
  path its close is given no transaction; where the native engine
  applies the checkpoint, the ledger's transaction record is taken out.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("control", "answer_altered", "half_left_out", "state_unchanged")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def _verdicts_altered(alter):
    """verify_batch_async with `alter(pks, sigs, msgs, verdicts)` applied
    to what each collector returns."""
    from stellar_core_tpu_torch.accel import ed25519
    orig = ed25519.verify_batch_async

    def verify_batch_async(pks, sigs, msgs, *args, **kw):
        collect = orig(pks, sigs, msgs, *args, **kw)

        def done():
            return alter(np.array(collect(), dtype=bool))
        return done
    return _patched(ed25519, "verify_batch_async", verify_batch_async)


@contextlib.contextmanager
def control():
    from stellar_core_tpu_torch.crypto import sodium

    def all_valid(v):
        v[:] = True
        return v

    with _verdicts_altered(all_valid), \
            _patched(sodium, "verify_detached", lambda *a: True):
        yield


def answer_altered():
    def flip(v):
        if len(v):
            v[0] = not v[0]
        return v
    return _verdicts_altered(flip)


def half_left_out():
    from stellar_core_tpu_torch.accel import ed25519
    orig = ed25519.verify_batch_async

    def verify_batch_async(pks, sigs, msgs, *args, **kw):
        half = len(pks) - len(pks) // 2
        collect = orig(pks[:half], sigs[:half], msgs[:half], *args, **kw)

        def done():
            v = np.ones(len(pks), dtype=bool)
            v[:half] = collect()
            return v
        return done
    return _patched(ed25519, "verify_batch_async", verify_batch_async)


@contextlib.contextmanager
def state_unchanged():
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.ledger.native_apply import NativeApplyBridge
    close = LedgerManager.close_ledger
    apply = NativeApplyBridge.apply_checkpoint

    def close_ledger(mgr, frames, *args, **kw):
        if (mgr.lcl_header.ledgerSeq + 1) % 4 == 0:
            frames = []
        return close(mgr, frames, *args, **kw)

    def apply_checkpoint(bridge, header_recs, tx_recs, max_seq):
        # a ledger's transaction record starts with its sequence number
        tx_recs = [None if r is not None
                   and int.from_bytes(r[:4], "big") % 4 == 0 else r
                   for r in tx_recs]
        return apply(bridge, header_recs, tx_recs, max_seq)

    with _patched(LedgerManager, "close_ledger", close_ledger), \
            _patched(NativeApplyBridge, "apply_checkpoint", apply_checkpoint):
        yield


def plant(name: str):
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; have {FAULTS}")
    return globals()[name]()
