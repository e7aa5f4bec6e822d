"""The port's autoscale package: so far only the windowed-stats
primitive (``metrics.stats_delta``).  The controller, policies and
parking come with queue item A6."""
