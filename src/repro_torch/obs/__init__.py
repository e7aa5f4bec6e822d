"""Off-by-default observability of the port's serving and control planes:
the counterpart of ``repro/obs`` for its two in-process pieces.

* :mod:`repro_torch.obs.trace` -- bounded ring-buffer :class:`Tracer`
  of typed span/instant events (request lifecycle, scheduler);
* :mod:`repro_torch.obs.metrics` -- fixed-bucket :class:`Histogram` +
  :class:`MetricsRegistry` with Prometheus text exposition.

Everything is a no-op until :func:`enable` / :func:`enable_metrics` is
called.  The reference's exporters, trace summarizer and ``/metrics``
listener (``obs/{export,summary,http}.py``) are not ported yet.
"""

from .trace import (  # noqa: F401
    DEFAULT_CAPACITY, Tracer, current, disable, enable,
)
from .metrics import (  # noqa: F401
    LATENCY_BOUNDS, OCCUPANCY_BOUNDS, Histogram, MetricsRegistry,
    current_metrics, disable_metrics, enable_metrics, hist_delta,
    hist_merge,
)
