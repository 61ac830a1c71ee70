"""verify.prep_ms_per_ksig.catchup: the verify entry's host prep, CPU ms per
thousand signatures, over the replay window (lib/spans.py)."""
from portbench.lib.spans import prep_ms_per_ksig as read  # noqa: F401
