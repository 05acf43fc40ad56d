"""``epilogue_roofline_pct`` of the 6-view backlog, where it moves ``volumes_per_s.6view``."""

from benchmark.core import metric_reader

read = metric_reader("epilogue_roofline_pct").read
