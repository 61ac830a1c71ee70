"""ledger.close_ms.catchup: mean ms of a replayed ledger's close."""
from portbench.lib.readers import close_ms as read  # noqa: F401
