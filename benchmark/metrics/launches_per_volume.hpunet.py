"""``launches_per_volume`` of the hpunet backlog, where it moves ``volumes_per_s`` too."""

from benchmark.core import metric_reader

read = metric_reader("launches_per_volume").read
