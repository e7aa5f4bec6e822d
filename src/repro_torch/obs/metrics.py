"""Fixed-bucket histograms + a Prometheus-style text exposition.
A copy of ``repro/obs/metrics.py``.

Rates and sums (``EngineStats``, ``stats_delta``) cannot answer is distributional: p95 TTFT, tail decode latency, how full
decode batches actually run.  :class:`Histogram` is the fixed-bucket
primitive (observe = one ``bisect`` + two adds -- cheap enough for the
per-tick serving path), and :class:`MetricsRegistry` is the process-wide
collection of counters / gauges / histograms with a ``render()`` that
emits the Prometheus text exposition format.

Off by default, same discipline as ``obs.trace``: the module
global :data:`METRICS` is ``None`` until :func:`enable_metrics`;
instrumentation sites guard on it (one attribute read + ``None`` check
when disabled).

Windowed semantics: histogram bucket counts are monotonic counters, so
they delta and merge exactly like the engine counters.
:func:`hist_delta` / :func:`hist_merge` operate on the plain-dict
snapshot form (``to_dict``), which is what ``StatsView.cumulative()`` carries
and ``autoscale.metrics.stats_delta`` windows -- counter resets (a
fresh engine reusing an app name) clamp to the current value instead of
going negative.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

#: the process-wide registry; None = metrics disabled (the default)
METRICS: Optional["MetricsRegistry"] = None

#: default bucket bounds (upper edges, seconds) for latency histograms:
#: log-spaced from 50us to ~26s -- covers a CPU smoke decode step and a
#: pathological multi-second TTFT in the same 20 buckets
LATENCY_BOUNDS = tuple(50e-6 * 2 ** i for i in range(20))

#: batch occupancy / queue depth: linear small-integer buckets
OCCUPANCY_BOUNDS = tuple(float(i) for i in range(1, 33))


class Histogram:
    """Fixed upper-edge buckets, cumulative on render (Prometheus
    ``le`` semantics), plain per-bucket counts in memory."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = LATENCY_BOUNDS):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        assert list(self.bounds) == sorted(self.bounds), \
            "histogram bounds must be sorted"
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_right(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    # -- analysis ------------------------------------------------------------
    def percentile(self, p: float) -> float:
        """Approximate p-quantile (0..100): the upper edge of the bucket
        containing the p-th observation (+inf -> the last finite edge).
        Exact enough for dashboards; the trace file has the raw points."""
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return (self.bounds[i] if i < len(self.bounds)
                        else self.bounds[-1])
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / max(self.count, 1)

    # -- snapshot / delta / merge (the windowed-stats integration) -----------
    def to_dict(self) -> Dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    @classmethod
    def from_dict(cls, d: Dict) -> "Histogram":
        h = cls(d["bounds"])
        h.counts = [int(c) for c in d["counts"]]
        h.sum = float(d["sum"])
        h.count = int(d["count"])
        return h

    def merge(self, other: "Histogram") -> "Histogram":
        """Element-wise sum (same bounds required): the cross-replica /
        cross-app aggregation the future router will lean on."""
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different "
                             f"bounds: {self.bounds} vs {other.bounds}")
        out = Histogram(self.bounds)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.sum = self.sum + other.sum
        out.count = self.count + other.count
        return out


def hist_delta(cur: Dict, since: Optional[Dict]) -> Dict:
    """Windowed view of a histogram snapshot dict: per-bucket counter
    deltas since ``since``.  A counter reset (since > cur anywhere, e.g.
    a fresh engine re-registered under an old app name) clamps to the
    CURRENT values -- a window must never report negative counts."""
    if since is None or since.get("bounds") != cur.get("bounds"):
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in cur.items()}
    counts = [c - s for c, s in zip(cur["counts"], since["counts"])]
    if any(c < 0 for c in counts):
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in cur.items()}
    return {"bounds": list(cur["bounds"]), "counts": counts,
            "sum": max(cur["sum"] - since["sum"], 0.0),
            "count": max(cur["count"] - since["count"], 0)}


def hist_merge(dicts: Sequence[Dict]) -> Dict:
    """Merge histogram snapshot dicts (same bounds) element-wise."""
    hs = [Histogram.from_dict(d) for d in dicts]
    out = hs[0]
    for h in hs[1:]:
        out = out.merge(h)
    return out.to_dict()


class MetricsRegistry:
    """Counters / gauges / histograms keyed ``(name, labels)``, with a
    Prometheus text exposition.  Labels are a sorted tuple of ``(k, v)``
    pairs (``app`` is the one the serving plane uses)."""

    def __init__(self):
        self.counters: Dict[Tuple, float] = {}
        self.gauges: Dict[Tuple, float] = {}
        self.histograms: Dict[Tuple, Histogram] = {}

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> Tuple:
        return (name, tuple(sorted(labels.items())))

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = self._key(name, labels)
        self.counters[k] = self.counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self.gauges[self._key(name, labels)] = float(value)

    def histogram(self, name: str, bounds: Sequence[float] = LATENCY_BOUNDS,
                  **labels) -> Histogram:
        """Get-or-create: instrumentation can hold the returned object
        and call ``observe`` directly (no per-observation dict lookup)."""
        k = self._key(name, labels)
        h = self.histograms.get(k)
        if h is None:
            h = Histogram(bounds)
            self.histograms[k] = h
        return h

    def app_histograms(self, app: str) -> Dict[str, Dict]:
        """Snapshot dicts of every histogram labeled ``app=<app>`` --
        the ``hist`` sub-dict ``StatsView.cumulative()`` carries."""
        out = {}
        for (name, labels), h in self.histograms.items():
            if ("app", app) in labels:
                out[name] = h.to_dict()
        return out

    # -- exposition ----------------------------------------------------------
    @staticmethod
    def _label_str(labels: Tuple, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> str:
        """Prometheus text exposition of everything registered."""
        lines: List[str] = []
        for (name, labels), v in sorted(self.counters.items()):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{self._label_str(labels)} {v:g}")
        for (name, labels), v in sorted(self.gauges.items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{self._label_str(labels)} {v:g}")
        for (name, labels), h in sorted(self.histograms.items()):
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for edge, c in zip(h.bounds, h.counts):
                cum += c
                le = 'le="%g"' % edge
                lines.append(f"{name}_bucket"
                             f"{self._label_str(labels, le)} {cum}")
            cum += h.counts[-1]
            lines.append(f"{name}_bucket"
                         + self._label_str(labels, 'le="+Inf"')
                         + f" {cum}")
            lines.append(f"{name}_sum{self._label_str(labels)} {h.sum:g}")
            lines.append(f"{name}_count{self._label_str(labels)} {h.count}")
        return "\n".join(lines) + "\n"


def enable_metrics() -> MetricsRegistry:
    """Install (and return) a fresh process-wide registry."""
    global METRICS
    METRICS = MetricsRegistry()
    return METRICS


def disable_metrics() -> Optional[MetricsRegistry]:
    global METRICS
    m, METRICS = METRICS, None
    return m


def current_metrics() -> Optional[MetricsRegistry]:
    return METRICS
