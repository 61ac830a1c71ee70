"""ledger.close_ms.tx: mean ms of the validator's ledger closes."""
from portbench.lib.readers import close_ms as read  # noqa: F401
