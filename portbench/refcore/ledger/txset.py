"""Transaction sets of either shape: the legacy TransactionSet and the
generalized one (TransactionSetV1), whose phases hold the envelopes
(reference: TxSetFrame / GeneralizedTransactionSet in stellar-core)."""

from __future__ import annotations

from typing import List

from .. import xdr as X


def is_generalized(tx_set) -> bool:
    return isinstance(tx_set, X.GeneralizedTransactionSet)


def tx_set_envelopes(tx_set) -> List[X.TransactionEnvelope]:
    if not is_generalized(tx_set):
        return list(tx_set.txs)
    return [e for phase in tx_set.value.phases for comp in phase.value
            for e in comp.value.txs]


def decode_tx_set(blob: bytes):
    """Decode a tx set of either shape.  The generalized union has exactly
    one arm, so its wire form starts with the 4-byte discriminant 1; a
    legacy set starts with a previous-ledger hash.  Whichever decode is
    tried must consume the whole blob, or the other is tried."""
    if blob[:4] == (1).to_bytes(4, "big"):
        try:
            return X.GeneralizedTransactionSet.from_xdr(blob)
        except X.XdrError:
            pass
    return X.TransactionSet.from_xdr(blob)
