"""``device_idle_pct.backlog`` of the hpunet backlog, where it moves ``volumes_per_s`` too."""

from benchmark.core import metric_reader

read = metric_reader("device_idle_pct.backlog").read
