"""device.idle_pct.channels: the card's idle share of the replay window."""
from portbench.lib.readers import idle_pct as read  # noqa: F401
