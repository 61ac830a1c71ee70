"""device.idle_pct.tx: the card's idle share of the validator's window."""
from portbench.lib.readers import idle_pct as read  # noqa: F401
