"""catchup.cpu_verify_pct.channels: the share of the replay's signature
checks at apply that the CPU verified (metrics/catchup.cpu_verify_pct.py)."""
from portbench.lib.harness import metric_reader

read = metric_reader("catchup.cpu_verify_pct")
