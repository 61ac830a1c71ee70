"""catchup.bucket_apply_ms.channels: mean ms of a pass's bucket apply
(metrics/catchup.bucket_apply_ms.catchup.py)."""
from portbench.lib.harness import metric_reader

read = metric_reader("catchup.bucket_apply_ms.catchup")
