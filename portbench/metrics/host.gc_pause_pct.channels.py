"""host.gc_pause_pct.channels: the collector's share of the traced replay
window (metrics/host.gc_pause_pct.catchup.py)."""
from portbench.lib.harness import metric_reader

read = metric_reader("host.gc_pause_pct.catchup")
