"""Generalized transaction sets (TransactionSetV1) — build + inspect.

A generalized set carries PHASES (reference: TxSetFrame /
GeneralizedTransactionSet in stellar-core): phase 0 is classic, phase 1
is Soroban.  Each phase is a list of TxSetComponents whose optional
baseFee records the per-phase surge-pricing floor the nominator applied.
The repo nominates a generalized set only when the Soroban phase is
non-empty — pure-classic ledgers keep the legacy TransactionSet shape
(and its hashes) byte-for-byte.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from .. import xdr as X

__all__ = ["SOROBAN_OP_TYPES", "build_generalized_tx_set", "decode_tx_set",
           "is_generalized", "is_soroban_frame", "is_soroban_envelope",
           "tx_set_envelopes", "tx_set_phases", "tx_set_previous_hash",
           "phase_base_fees"]

SOROBAN_OP_TYPES = frozenset((
    X.OperationType.INVOKE_HOST_FUNCTION,
    X.OperationType.EXTEND_FOOTPRINT_TTL,
    X.OperationType.RESTORE_FOOTPRINT,
))


def is_soroban_envelope(envelope: X.TransactionEnvelope) -> bool:
    tx = envelope.value.tx
    if hasattr(tx, "innerTx"):          # fee bump: inspect the inner tx
        tx = tx.innerTx.value.tx
    return any(op.body.switch in SOROBAN_OP_TYPES for op in tx.operations)


def is_soroban_frame(frame) -> bool:
    return is_soroban_envelope(frame.envelope)


def is_generalized(tx_set) -> bool:
    return isinstance(tx_set, X.GeneralizedTransactionSet)


def _component(envelopes: Sequence[X.TransactionEnvelope],
               base_fee: Optional[int]) -> X.TxSetComponent:
    return X.TxSetComponent.txsMaybeDiscountedFee(
        X.TxSetComponentTxsMaybeDiscountedFee(
            baseFee=base_fee, txs=list(envelopes)))


def _phase(envelopes: Sequence[X.TransactionEnvelope],
           base_fee: Optional[int]) -> X.TransactionPhase:
    comps = [] if not envelopes else [_component(envelopes, base_fee)]
    return X.TransactionPhase.v0Components(comps)


def build_generalized_tx_set(
        previous_ledger_hash: bytes,
        classic_frames: Sequence,
        soroban_frames: Sequence,
        classic_base_fee: Optional[int] = None,
        soroban_base_fee: Optional[int] = None,
) -> Tuple[X.GeneralizedTransactionSet, bytes]:
    """Build the two-phase set; frames are hash-sorted per phase exactly
    like make_tx_set sorts the legacy shape.  Returns (set, sha256)."""
    classic = sorted(classic_frames, key=lambda f: f.content_hash())
    soroban = sorted(soroban_frames, key=lambda f: f.content_hash())
    gts = X.GeneralizedTransactionSet.v1TxSet(X.TransactionSetV1(
        previousLedgerHash=previous_ledger_hash,
        phases=[
            _phase([f.envelope for f in classic], classic_base_fee),
            _phase([f.envelope for f in soroban], soroban_base_fee),
        ]))
    return gts, hashlib.sha256(gts.to_xdr()).digest()


def tx_set_phases(tx_set) -> List[List[X.TransactionEnvelope]]:
    """Per-phase envelope lists.  Legacy sets read as one classic phase
    with an empty Soroban phase, so close-side code has ONE shape."""
    if not is_generalized(tx_set):
        return [list(tx_set.txs), []]
    out: List[List[X.TransactionEnvelope]] = []
    for phase in tx_set.value.phases:
        envs: List[X.TransactionEnvelope] = []
        for comp in phase.value:
            envs.extend(comp.value.txs)
        out.append(envs)
    while len(out) < 2:
        out.append([])
    return out


def phase_base_fees(tx_set) -> List[Optional[int]]:
    """The declared per-phase discounted base fees (None = no discount)."""
    if not is_generalized(tx_set):
        return [None, None]
    fees: List[Optional[int]] = []
    for phase in tx_set.value.phases:
        fee = None
        for comp in phase.value:
            if comp.value.baseFee is not None:
                fee = int(comp.value.baseFee)
        fees.append(fee)
    while len(fees) < 2:
        fees.append(None)
    return fees


def tx_set_envelopes(tx_set) -> List[X.TransactionEnvelope]:
    return [e for phase in tx_set_phases(tx_set) for e in phase]


def tx_set_previous_hash(tx_set) -> bytes:
    return (tx_set.value.previousLedgerHash if is_generalized(tx_set)
            else tx_set.previousLedgerHash)


def decode_tx_set(blob: bytes):
    """Decode a persisted/peer-sent tx set of either shape.  The
    generalized union has exactly one arm, so its wire form starts with
    the 4-byte discriminant 1; a legacy set starts with a previous-ledger
    hash, for which those bytes are vanishingly unlikely.  The misparse
    direction is guarded anyway: whichever decode is tried must consume
    the whole blob or XdrError propagates to the fallback."""
    if blob[:4] == (1).to_bytes(4, "big"):
        try:
            return X.GeneralizedTransactionSet.from_xdr(blob)
        except X.XdrError:
            pass
    return X.TransactionSet.from_xdr(blob)
