"""catchup.apply_ms_per_ledger.channels: milliseconds of checkpoint apply
a replayed ledger, less the wait for the card's verdicts
(metrics/catchup.apply_ms_per_ledger.catchup.py)."""
from portbench.lib.harness import metric_reader

read = metric_reader("catchup.apply_ms_per_ledger.catchup")
