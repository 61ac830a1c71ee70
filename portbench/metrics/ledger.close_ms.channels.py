"""ledger.close_ms.channels: mean ms of a replayed ledger's close."""
from portbench.lib.readers import close_ms as read  # noqa: F401
