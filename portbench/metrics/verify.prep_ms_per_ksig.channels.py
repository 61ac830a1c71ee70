"""verify.prep_ms_per_ksig.channels: the verify entry's host prep, CPU ms
per thousand signatures, over the replay window (lib/spans.py): the key
decode, the hashes and the hot/cold split with its ranking of the keys
that want a table."""
from portbench.lib.spans import prep_ms_per_ksig as read  # noqa: F401
