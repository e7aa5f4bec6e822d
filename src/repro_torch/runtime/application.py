"""Application: the resource-centric unit users program against.
A copy of ``repro/runtime/application.py`` over the port's configs and
profiles.

The paper's core claim is that the *application* -- not a function -- is
what users hand to the platform, and the platform sizes, places, scales,
and recovers it (§2, §4).  An :class:`Application` bundles everything the
platform needs to do that:

* the model/program definition (a built-in ``ModelConfig`` via
  ``get_config``, or a user callable annotated with ``@compute`` /
  ``@data`` / ``@app_limit``),
* the invocation class (a ``ShapeConfig``: train / prefill / decode at a
  given sequence length and batch),
* the spending cap (``AppLimits``), and
* workload options the executor reads (steps, requests, batch sizes...).

Applications are descriptions only: nothing touches torch or device state
until a :class:`~repro_torch.runtime.cluster.Cluster` accepts the
submission.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config)
from repro_torch.configs.reduced import reduced_config
from repro_torch.core import profiles as prof
from repro_torch.core.annotations import AppLimits, current_app_limits
from repro_torch.core.graph import ResourceGraph, build_resource_graph
from repro_torch.runtime.options import ServeOptions

# CPU smoke-scale invocation classes (same code path, reduced size)
REDUCED_SHAPES = {
    "train": ShapeConfig("reduced_train", "train", 64, 8),
    "prefill": ShapeConfig("reduced_prefill", "prefill", 64, 4),
    "decode": ShapeConfig("reduced_decode", "decode", 64, 4),
}


def _resolve_config(config: Union[str, ModelConfig]) -> ModelConfig:
    return get_config(config) if isinstance(config, str) else config


@dataclass
class Application:
    """One bulky application: a model/program plus its invocation class."""

    name: str
    kind: str                              # train | serve
    config: Optional[ModelConfig] = None   # None for synthetic (sim-only)
    shape: Optional[ShapeConfig] = None
    limits: AppLimits = field(default_factory=AppLimits)
    reduced: bool = False
    demand_bytes: Optional[int] = None     # explicit footprint override
    demand_chips: int = 1
    options: Dict[str, Any] = field(default_factory=dict)
    #: the typed serve surface (serve apps)
    serve_options: Optional[ServeOptions] = None
    _graph: Optional[ResourceGraph] = field(default=None, repr=False)

    # -- constructors -------------------------------------------------------
    @classmethod
    def train(cls, config: Union[str, ModelConfig], *,
              shape: Union[str, ShapeConfig] = "train_4k",
              reduced: bool = False, name: Optional[str] = None,
              limits: Optional[AppLimits] = None,
              **options) -> "Application":
        cfg = _resolve_config(config)
        sh = SHAPES[shape] if isinstance(shape, str) else shape
        if reduced:
            cfg = reduced_config(cfg)
            sh = REDUCED_SHAPES["train"]
        # stable default identity: history-based sizing keys on the app name
        return cls(name or f"{cfg.name}:train", "train",
                   cfg, sh, limits or AppLimits(), reduced, options=options)

    @classmethod
    def serve(cls, config: Union[str, ModelConfig], *,
              shape: Union[str, ShapeConfig] = "decode_32k",
              reduced: bool = False, name: Optional[str] = None,
              limits: Optional[AppLimits] = None,
              serve: Optional[ServeOptions] = None) -> "Application":
        cfg = _resolve_config(config)
        sh = SHAPES[shape] if isinstance(shape, str) else shape
        if reduced:
            cfg = reduced_config(cfg)
            sh = REDUCED_SHAPES["decode"]
        return cls(name or f"{cfg.name}:serve", "serve",
                   cfg, sh, limits or AppLimits(), reduced,
                   serve_options=serve or ServeOptions())

    @classmethod
    def from_callable(cls, app_fn: Callable[[], ModelConfig], *,
                      kind: str = "train",
                      shape: Union[str, ShapeConfig] = "train_4k",
                      serve: Optional[ServeOptions] = None,
                      **options) -> "Application":
        """Build from an annotated user 'source program'.

        ``app_fn`` is a callable (typically decorated with ``@compute`` /
        ``@app_limit``) returning the program's ``ModelConfig``; its
        annotations become the application's components and spending cap."""
        cfg = app_fn()
        limits = getattr(app_fn, "__app_limits__", None) or current_app_limits()
        comp = getattr(app_fn, "__component__", None)
        name = (comp or {}).get("name") or getattr(
            app_fn, "__name__", "user-app")
        sh = SHAPES[shape] if isinstance(shape, str) else shape
        if kind == "train":
            if serve is not None:
                raise TypeError("from_callable: serve=ServeOptions is only "
                                "valid with kind='serve'")
            return cls.train(cfg, shape=sh, name=name, limits=limits,
                             **options)
        if options:
            raise TypeError(f"from_callable: serve options go in "
                            f"serve=ServeOptions(...), not {sorted(options)}")
        return cls.serve(cfg, shape=sh, name=name, limits=limits,
                         serve=serve)

    @classmethod
    def synthetic(cls, name: str, kind: str, demand_bytes: int,
                  demand_chips: int = 1) -> "Application":
        """Simulation-only application with an explicit footprint (no
        model, no graph, no device state)."""
        return cls(name, kind, demand_bytes=demand_bytes,
                   demand_chips=demand_chips)

    # -- resource profile ---------------------------------------------------
    def resource_graph(self) -> Optional[ResourceGraph]:
        """The paper's IR for this application (cached; None if synthetic)."""
        if self.config is None:
            return None
        if self._graph is None:
            self._graph = build_resource_graph(self.config, self.shape)
        return self._graph

    def estimate_demand(self) -> int:
        """Proactive footprint estimate in bytes (profiles; pre-history)."""
        if self.demand_bytes is not None:
            return self.demand_bytes
        cfg, shape = self.config, self.shape
        p = prof.param_bytes(cfg)
        if shape.kind == "train":
            return int(p + prof.optimizer_bytes(cfg)
                       + prof.activation_bytes_train(cfg, shape))
        return int(p + prof.kv_cache_bytes(cfg, shape))

    def structural_floor(self) -> int:
        """Bytes that must be resident from the first step regardless of
        history: params (+ optimizer state for training).  History-based
        sizing may shrink the input-dependent share (activations, KV)
        below the proactive estimate, but never below this."""
        if self.config is None:
            return 0
        p = prof.param_bytes(self.config)
        if self.kind == "train":
            return int(p + prof.optimizer_bytes(self.config))
        return int(p)

    def capped_demand(self, demand: int) -> int:
        """Apply the @app_limit spending cap to a demand estimate."""
        if self.limits.max_hbm_bytes is not None:
            demand = min(demand, self.limits.max_hbm_bytes)
        return demand
