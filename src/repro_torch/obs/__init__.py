"""repro_torch.obs -- off-by-default observability for the serving and
control planes: the port's copy of ``repro/obs``.

Four pieces:

* :mod:`repro_torch.obs.trace` -- bounded ring-buffer :class:`Tracer` of
  typed span/instant events across request lifecycle, pool
  arbitration, compiles, and autoscale decisions;
* :mod:`repro_torch.obs.metrics` -- fixed-bucket :class:`Histogram` +
  :class:`MetricsRegistry` with Prometheus text exposition;
* :mod:`repro_torch.obs.export` / :mod:`repro_torch.obs.summary` -- Chrome
  trace-event JSON / JSONL exporters and the ``python -m repro_torch.obs``
  trace summarizer;
* :mod:`repro_torch.obs.http` -- a stdlib streaming ``/metrics`` listener
  (Prometheus text exposition) for pull-based scraping.

Everything is a no-op until :func:`enable` / :func:`enable_metrics` is
called; instrumentation sites pay one module-attribute read + ``None``
check when disabled.
"""

from .trace import (  # noqa: F401
    DEFAULT_CAPACITY, Tracer, current, disable, enable,
)
from .metrics import (  # noqa: F401
    LATENCY_BOUNDS, OCCUPANCY_BOUNDS, Histogram, MetricsRegistry,
    current_metrics, disable_metrics, enable_metrics, hist_delta,
    hist_merge,
)
from .export import (  # noqa: F401
    load_events, to_chrome_events, write_chrome_trace, write_jsonl,
)
from .http import MetricsServer, serve_metrics  # noqa: F401
from .summary import request_lifecycles, summarize  # noqa: F401
