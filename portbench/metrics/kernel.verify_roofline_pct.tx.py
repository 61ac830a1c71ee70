"""kernel.verify_roofline_pct.tx: the verify kernels' share of their
roofline over the validator's window (lib/peaks.py)."""
from portbench.lib.readers import verify_roofline_pct as read  # noqa: F401
