"""``gather_roofline_pct`` of the hpunet backlog, where it moves ``volumes_per_s`` too."""

from benchmark.core import metric_reader

read = metric_reader("gather_roofline_pct").read
