"""kernel.verify_roofline_pct.catchup: the verify kernels' share of their
roofline over the replay window (lib/peaks.py)."""
from portbench.lib.readers import verify_roofline_pct as read  # noqa: F401
