"""User-facing annotations: the paper's @compute / @data / @app_limit.
A copy of ``repro/core/annotations.py``.

In BulkX users annotate monolithic source programs; here users annotate
model/program definitions.  Annotations register components with the
resource-graph builder so custom user programs (beyond the built-in
architectures) get the same adaptive treatment.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

_REGISTRY = threading.local()


def _components() -> List[dict]:
    if not hasattr(_REGISTRY, "items"):
        _REGISTRY.items = []
    return _REGISTRY.items


def reset_annotations() -> None:
    _REGISTRY.items = []


def collected_annotations() -> List[dict]:
    return list(_components())


@dataclass
class AppLimits:
    max_chips: Optional[int] = None
    max_hbm_bytes: Optional[int] = None


_APP_LIMITS = AppLimits()


def app_limit(*, max_chips: Optional[int] = None,
              max_hbm_bytes: Optional[int] = None):
    """Global spending cap (paper: @app_limit(max_cpu, max_mem))."""
    def deco(fn):
        global _APP_LIMITS
        _APP_LIMITS = AppLimits(max_chips, max_hbm_bytes)
        fn.__app_limits__ = _APP_LIMITS
        return fn
    return deco


def current_app_limits() -> AppLimits:
    return _APP_LIMITS


def compute(fn: Optional[Callable] = None, *, parallelism: str = "token",
            name: Optional[str] = None):
    """Mark a callable as a compute component (distinct FLOPs/parallelism).

    The wrapped function behaves identically; the call site is recorded so
    the resource-graph builder can create a node for it."""
    def deco(f):
        comp = {"kind": "compute", "name": name or f.__name__,
                "parallelism": parallelism, "fn": f.__qualname__}
        _components().append(comp)

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return f(*args, **kwargs)
        wrapper.__component__ = comp
        return wrapper
    if fn is not None:
        return deco(fn)
    return deco


def data(name: str, *, input_dependent: bool = False,
         lifetime: str = "step"):
    """Mark an array-producing callable as a data component."""
    def deco(f):
        comp = {"kind": "data", "name": name,
                "input_dependent": input_dependent, "lifetime": lifetime,
                "fn": f.__qualname__}
        _components().append(comp)

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return f(*args, **kwargs)
        wrapper.__component__ = comp
        return wrapper
    return deco
