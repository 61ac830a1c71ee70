"""The port's own copy of the transaction-level checks
(stellar_core_tpu/transactions)."""
