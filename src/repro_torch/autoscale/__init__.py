"""repro_torch.autoscale -- the resource-centric control plane: the
port's copy of ``repro/autoscale``.

Closes the feedback loop the paper's headline result rests on: the
platform watches each serve application's windowed signals
(:mod:`~repro_torch.autoscale.metrics`), pluggable policies turn them into
scale/park decisions (:mod:`~repro_torch.autoscale.policy`), a tick-driven
controller applies them with hysteresis and cooldowns
(:mod:`~repro_torch.autoscale.controller`), and idle applications are
parked -- weights and KV to the host, device memory, pool pages and
scheduler bytes released -- and transparently unparked on the next
request (:mod:`~repro_torch.autoscale.parking`).

Typical use::

    cluster = Cluster(pods=1, executor=TorchExecutor())
    cluster.enable_autoscale(idle_park_s=30.0)
    handle = cluster.submit(Application.serve(
        ..., serve=ServeOptions(quota_pages=32)))
    ...
    cluster.tick()          # one reconcile round (call from your loop)

An app that attaches a ``ScalePolicy`` to its ``ServeOptions`` also
gets replica-count and batch-width scaling (``ReplicaScaler``,
``BatchScaler``) and predictive unparking (``PredictiveUnparker``).
"""

from repro_torch.autoscale.controller import AppRecord, AutoscaleController
from repro_torch.autoscale.metrics import MetricsWindow, stats_delta
from repro_torch.autoscale.parking import (ParkedApp, ParkedRequest, park_app,
                                     unpark_app)
from repro_torch.autoscale.policy import (AppPolicy, BatchScaler, Decision,
                                    IdleParker, PredictiveUnparker,
                                    QuotaRebalancer, ReplicaScaler,
                                    TargetTracking, default_policies,
                                    sizing_step_bytes)

__all__ = [
    "AppPolicy", "AppRecord", "AutoscaleController", "BatchScaler",
    "Decision", "IdleParker", "MetricsWindow", "ParkedApp",
    "ParkedRequest", "PredictiveUnparker", "QuotaRebalancer",
    "ReplicaScaler", "TargetTracking", "default_policies", "park_app",
    "sizing_step_bytes", "stats_delta", "unpark_app",
]
