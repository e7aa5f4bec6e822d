"""Typed serve-time options: the resource-centric serve API surface.
A copy of ``repro/runtime/options.py`` with its validation rules.

``ServeOptions`` holds the serving knobs of one application in one
frozen, validated dataclass, the only way ``Application.serve`` takes
them.  Cross-field rules (e.g. dense + prefix cache) are checked here
at construction time, where the error points at the line that made the
bad choice.

``ScalePolicy`` declares the *platform-owned* scaling dimensions for
one app -- replica count and continuous-batch width -- plus the
predictive-unpark knob.  The app states bounds and targets; the
autoscale control plane (the reference's ``repro/autoscale``, not ported
yet) moves within them.

The port's executor serves one replica on a private pool; what it cannot
serve yet (``private_pool=False``, ``prefix_cache``, ``alias_kv``, a
``scale`` policy) is refused at bind time with the queue item that brings
it, not here: the options stay the reference's, field for field.
"""

from dataclasses import dataclass
from typing import Optional

BACKENDS = ("dense", "paged")
POOL_POLICIES = ("fixed", "history", "peak")


@dataclass(frozen=True)
class ScalePolicy:
    """Bounds and targets for platform-owned scaling of one serve app.

    Replica scaling target-tracks the *windowed* router queue depth per
    replica; batch scaling target-tracks decode occupancy.  Setting
    ``min_replicas=0`` allows scale-to-zero, which is the reference's
    park path (KV to host, pages and param bytes released).
    """

    min_replicas: int = 1
    max_replicas: int = 1
    #: windowed router+engine queue depth per replica that triggers
    #: adding a replica
    target_queue_per_replica: float = 4.0
    #: decode occupancy (running / (replicas * max_batch)) below which a
    #: replica is drained (and below which the batch is narrowed)
    shrink_occupancy: float = 0.25
    #: occupancy at or above which the batch is widened
    grow_occupancy: float = 0.9
    #: continuous-batch width bounds; ``batch_max=None`` disables batch
    #: scaling (the width stays at ``ServeOptions.max_batch``)
    batch_min: int = 1
    batch_max: Optional[int] = None
    #: wake a parked app ahead of the EWMA-forecast next arrival
    predictive_unpark: bool = True
    unpark_lead_s: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError("ScalePolicy: min_replicas must be >= 0 "
                             f"(got {self.min_replicas})")
        if self.max_replicas < max(self.min_replicas, 1):
            raise ValueError(
                f"ScalePolicy: max_replicas={self.max_replicas} below "
                f"min_replicas={self.min_replicas} (and must be >= 1)")
        if self.batch_min < 1:
            raise ValueError("ScalePolicy: batch_min must be >= 1 "
                             f"(got {self.batch_min})")
        if self.batch_max is not None and self.batch_max < self.batch_min:
            raise ValueError(
                f"ScalePolicy: batch_max={self.batch_max} below "
                f"batch_min={self.batch_min}")
        if not (0.0 <= self.shrink_occupancy < self.grow_occupancy <= 1.0):
            raise ValueError(
                "ScalePolicy: need 0 <= shrink_occupancy < grow_occupancy "
                f"<= 1 (got {self.shrink_occupancy} / {self.grow_occupancy})")
        if self.unpark_lead_s < 0:
            raise ValueError("ScalePolicy: unpark_lead_s must be >= 0")

    @property
    def scales_replicas(self) -> bool:
        return self.max_replicas > 1 or self.min_replicas == 0

    @property
    def scales_batch(self) -> bool:
        return self.batch_max is not None


@dataclass(frozen=True)
class ServeOptions:
    """Everything a serve application asks of the data plane.

    ``max_batch=None`` and ``pool_pages=None`` defer to the executor's
    backend-specific defaults.  ``replicas`` is the *initial* replica
    count; with a ``scale`` policy attached the controller moves it
    within ``[min_replicas, max_replicas]``.
    """

    backend: str = "dense"
    max_batch: Optional[int] = None
    cache_len: int = 256
    replicas: int = 1
    #: pod-shared pool sizing / placement
    pool_pages: Optional[int] = None
    policy: str = "history"
    private_pool: bool = False
    quota_pages: Optional[int] = None
    weight: float = 1.0
    #: paged-backend features
    swa_rings: bool = True
    alias_kv: bool = True
    prefix_cache: bool = False
    chunk_pages: Optional[int] = None
    #: platform-owned scaling dimensions (None = fixed footprint)
    scale: Optional[ScalePolicy] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"ServeOptions: unknown backend "
                             f"{self.backend!r} (expected one of {BACKENDS})")
        if self.prefix_cache and self.backend != "paged":
            # moved here from build_runner: fail where the option is set
            raise ValueError(
                "ServeOptions: prefix_cache=True requires backend='paged' "
                "(the dense backend has no page identity to share)")
        if self.replicas < 1:
            raise ValueError("ServeOptions: replicas must be >= 1 "
                             f"(got {self.replicas})")
        if self.replicas > 1 and self.private_pool:
            raise ValueError(
                "ServeOptions: replicas > 1 requires the pod-shared pool "
                "(replicas alias one KV array set; private_pool=True "
                "would duplicate it)")
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError("ServeOptions: max_batch must be >= 1 "
                             f"(got {self.max_batch})")
        if self.policy not in POOL_POLICIES:
            raise ValueError(f"ServeOptions: unknown pool policy "
                             f"{self.policy!r} (expected {POOL_POLICIES})")
        if self.weight <= 0:
            raise ValueError("ServeOptions: weight must be > 0 "
                             f"(got {self.weight})")
        if self.scale is not None and self.scale.max_replicas < self.replicas:
            raise ValueError(
                f"ServeOptions: replicas={self.replicas} exceeds "
                f"scale.max_replicas={self.scale.max_replicas}")
