"""History store: decaying histograms of per-component resource usage.
A copy of ``repro/core/history.py`` (it imports nothing of either
package).

The paper (§4.2, §5.2.3) stores "a histogram of all captured statistics with
decaying weights at each resource graph node" and re-adjusts sizing
parameters every K executions.  This module is that store: observations are
bucketed into a log-scaled histogram whose weights decay geometrically with
each new sample, persisted as JSON per (app, component, metric).
"""

from __future__ import annotations

import json
import math
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


DEFAULT_DECAY = 0.98
NUM_BUCKETS = 64


@dataclass
class DecayedHistogram:
    """Log-bucketed histogram with exponential decay on weights."""
    lo: float = 1.0
    hi: float = float(1 << 48)
    decay: float = DEFAULT_DECAY
    weights: List[float] = field(default_factory=lambda: [0.0] * NUM_BUCKETS)
    count: int = 0
    last: float = 0.0

    def _bucket(self, v: float) -> int:
        v = min(max(v, self.lo), self.hi)
        frac = (math.log(v) - math.log(self.lo)) / (
            math.log(self.hi) - math.log(self.lo))
        return min(NUM_BUCKETS - 1, int(frac * NUM_BUCKETS))

    def _bucket_value(self, i: int) -> float:
        frac = (i + 0.5) / NUM_BUCKETS
        return math.exp(math.log(self.lo) + frac
                        * (math.log(self.hi) - math.log(self.lo)))

    def observe(self, v: float) -> None:
        self.weights = [w * self.decay for w in self.weights]
        self.weights[self._bucket(v)] += 1.0
        self.count += 1
        self.last = v

    def quantile(self, q: float) -> float:
        total = sum(self.weights)
        if total <= 0:
            return 0.0
        acc = 0.0
        for i, w in enumerate(self.weights):
            acc += w
            if acc >= q * total:
                return self._bucket_value(i)
        return self._bucket_value(NUM_BUCKETS - 1)

    def mean(self) -> float:
        total = sum(self.weights)
        if total <= 0:
            return 0.0
        return sum(w * self._bucket_value(i)
                   for i, w in enumerate(self.weights)) / total

    def peak(self) -> float:
        return self.quantile(1.0)

    def samples(self) -> List[Tuple[float, float]]:
        """(value, weight) pairs for the sizing LP."""
        return [(self._bucket_value(i), w)
                for i, w in enumerate(self.weights) if w > 0]

    def to_json(self) -> dict:
        return {"lo": self.lo, "hi": self.hi, "decay": self.decay,
                "weights": self.weights, "count": self.count,
                "last": self.last}

    @classmethod
    def from_json(cls, d: dict) -> "DecayedHistogram":
        return cls(lo=d["lo"], hi=d["hi"], decay=d["decay"],
                   weights=list(d["weights"]), count=int(d["count"]),
                   last=float(d.get("last", 0.0)))


class HistoryStore:
    """Per-(app, component, metric) decayed histograms with JSON persistence.

    Thread-safe: the runtime records observations from the training loop and
    the serving engine concurrently.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self._hists: Dict[str, DecayedHistogram] = {}
        self._lock = threading.Lock()
        if root:
            os.makedirs(root, exist_ok=True)
            self._load()

    @staticmethod
    def _key(app: str, component: str, metric: str) -> str:
        return f"{app}//{component}//{metric}"

    def observe(self, app: str, component: str, metric: str,
                value: float) -> None:
        key = self._key(app, component, metric)
        with self._lock:
            if key not in self._hists:
                self._hists[key] = DecayedHistogram()
            self._hists[key].observe(float(value))

    def get(self, app: str, component: str, metric: str
            ) -> Optional[DecayedHistogram]:
        return self._hists.get(self._key(app, component, metric))

    def quantile(self, app: str, component: str, metric: str, q: float,
                 default: float = 0.0) -> float:
        h = self.get(app, component, metric)
        return h.quantile(q) if h and h.count else default

    def peak(self, app: str, component: str, metric: str,
             default: float = 0.0) -> float:
        return self.quantile(app, component, metric, 1.0, default)

    # -- persistence --------------------------------------------------------
    def _path(self) -> str:
        return os.path.join(self.root, "history.json")

    def save(self) -> None:
        if not self.root:
            return
        with self._lock:
            payload = {k: h.to_json() for k, h in self._hists.items()}
        tmp = self._path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path())

    def _load(self) -> None:
        path = self._path()
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                payload = json.load(f)
            self._hists = {k: DecayedHistogram.from_json(v)
                           for k, v in payload.items()}
        except (json.JSONDecodeError, KeyError):
            self._hists = {}
