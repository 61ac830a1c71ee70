"""host.gc_full_passes.channels: the collector's full passes in the replay
window (metrics/host.gc_full_passes.catchup.py)."""
from portbench.lib.harness import metric_reader

read = metric_reader("host.gc_full_passes.catchup")
