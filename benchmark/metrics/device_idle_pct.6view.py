"""``device_idle_pct.backlog`` of the 6-view backlog, where it moves ``volumes_per_s.6view``."""

from benchmark.core import metric_reader

read = metric_reader("device_idle_pct.backlog").read
