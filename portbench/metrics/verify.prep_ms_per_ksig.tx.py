"""verify.prep_ms_per_ksig.tx: the verify entry's host prep, CPU ms per
thousand signatures, over the validator's window (lib/spans.py)."""
from portbench.lib.spans import prep_ms_per_ksig as read  # noqa: F401
