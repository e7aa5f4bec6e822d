"""Proactive build cache: the paper's pre-warm / pre-launch analog.

The port's copy of ``repro/core/compile_cache.py``, with the same API and
the same ``plan_layout_key``.  Paper §5.2.1 pre-launches the next
component's environment while the current one runs and caches runtime
compilations per component layout (§4.2: "once the runtime compiles a
version for one invocation, it is cached and reused for future
invocations with the same component layouts").

The cache keys on (arch, shape, mesh, plan-layout) -- the "component
layout" -- and holds built objects in-process: ``get_or_compile(key,
build)`` is single-flight per key.  The port's ``TorchExecutor`` caches
the train-step closure of a plan here; a captured CUDA graph keyed by
plan layout is the natural next entry.  The reference's on-disk setting
(``persistent_dir``, which points XLA's persistent compilation cache at
a directory) has no counterpart: the port's CUDA kernels are cached on
disk by their own build (``kernels/_build.py``, keyed by source hash),
so ``persistent_dir`` is accepted and only creates the directory.
``prewarm`` builds the *next* expected invocation class on a background
thread while the current one executes."""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.core.materializer import Plan


def plan_layout_key(arch: str, shape: str, mesh: str, plan: Plan) -> str:
    """The paper's 'component layout' identity."""
    d = plan.describe()
    d.pop("notes", None)
    d.pop("est_bytes_per_device", None)
    blob = json.dumps({"arch": arch, "shape": shape, "mesh": mesh, **d},
                      sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclass
class CacheEntry:
    key: str
    compiled: Any
    compile_time_s: float
    hits: int = 0
    created: float = field(default_factory=time.time)


class CompileCache:
    def __init__(self, persistent_dir: Optional[str] = None):
        self._entries: Dict[str, CacheEntry] = {}
        self._lock = threading.Lock()
        self._inflight: Dict[str, threading.Event] = {}
        self.stats = {"hits": 0, "misses": 0, "prewarmed": 0,
                      "prewarm_hits": 0}
        if persistent_dir:
            os.makedirs(persistent_dir, exist_ok=True)

    def get_or_compile(self, key: str, build: Callable[[], Any]) -> Any:
        """Blocking fetch; builds on miss (single-flight per key)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                ent.hits += 1
                self.stats["hits"] += 1
                return ent.compiled
            ev = self._inflight.get(key)
            if ev is None:
                ev = threading.Event()
                self._inflight[key] = ev
                owner = True
            else:
                owner = False
        if not owner:
            ev.wait()
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self.stats["hits"] += 1
                    return ent.compiled
            # fall through: owner failed; build ourselves
        t0 = time.time()
        compiled = build()
        with self._lock:
            self.stats["misses"] += 1
            self._entries[key] = CacheEntry(key, compiled, time.time() - t0)
            self._inflight.pop(key, None)
        ev.set()
        return compiled

    def prewarm(self, key: str, build: Callable[[], Any]) -> threading.Thread:
        """Build ahead of time on a background thread (pre-launch)."""
        def work():
            try:
                self.get_or_compile(key, build)
                with self._lock:
                    self.stats["prewarmed"] += 1
            except Exception:
                pass
        t = threading.Thread(target=work, daemon=True)
        t.start()
        return t

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._entries
