"""catchup.collect_wait_ms.channels: mean ms a preverify collect waited
for its group's verdicts (metrics/catchup.collect_wait_ms.catchup.py)."""
from portbench.lib.harness import metric_reader

read = metric_reader("catchup.collect_wait_ms.catchup")
