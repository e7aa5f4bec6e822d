"""Failure recovery and elasticity: graph cuts, stragglers, elastic resize.
A copy of ``repro/checkpoint/recovery.py``.

Paper §5.3.2: on failure, discard the crashed component and every data
component it accesses, find the latest *cut* of the resource graph whose
crossing edges are all persistently recorded, and re-execute from there.

Training substrate: the cut is the last committed checkpoint (params + opt
state + data cursor); "discard crashed components" = rebuild device state;
"re-execute from recorded inputs" = deterministic data pipeline replay from
the cursor.  Elastic resize re-materializes the SAME resource graph on a
smaller/larger mesh: the materializer produces a new plan, and the restore
path re-places every leaf under the new shardings.

Straggler mitigation: per-step wall-time watchdog based on a decayed
history of step times -- a step exceeding quantile(0.99) * slack flags the
participating host set; the driver responds by checkpoint-and-reshard
(shrinking the mesh away from the slow host), the accelerator analog of
work re-dispatch (a device's shard cannot be reassigned mid-step)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.history import DecayedHistogram
from repro_torch.core.materializer import MeshSpec, Plan, materialize


@dataclass
class RecoveryPoint:
    step: int
    ckpt_path: str
    data_cursor: int
    mesh_name: str


class CutTracker:
    """Tracks the latest persisted cut; decides what to re-execute."""

    def __init__(self):
        self.points: List[RecoveryPoint] = []

    def record(self, p: RecoveryPoint) -> None:
        self.points.append(p)

    def latest(self) -> Optional[RecoveryPoint]:
        return self.points[-1] if self.points else None

    def replay_span(self, failed_step: int) -> Tuple[int, int]:
        """(restart_step, lost_steps) after a failure at failed_step."""
        p = self.latest()
        start = p.step if p else 0
        return start, max(failed_step - start, 0)


class StragglerWatchdog:
    """Flags steps that exceed the historical p99 by a slack factor."""

    def __init__(self, slack: float = 2.0, warmup: int = 8):
        self.hist = DecayedHistogram(lo=1e-4, hi=1e4)
        self.slack = slack
        self.warmup = warmup
        self.flags: List[Tuple[int, float, float]] = []

    def observe(self, step: int, wall_s: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if self.hist.count >= self.warmup:
            thresh = self.hist.quantile(0.99) * self.slack
            if wall_s > thresh:
                is_straggler = True
                self.flags.append((step, wall_s, thresh))
        self.hist.observe(wall_s)
        return is_straggler


@dataclass
class ElasticPolicy:
    """Mesh downsize ladder on persistent failure/straggle."""
    mesh_options: List[MeshSpec]
    current: int = 0

    def current_mesh(self) -> MeshSpec:
        return self.mesh_options[self.current]

    def shrink(self) -> Optional[MeshSpec]:
        if self.current + 1 >= len(self.mesh_options):
            return None
        self.current += 1
        return self.mesh_options[self.current]

    def grow(self) -> Optional[MeshSpec]:
        if self.current == 0:
            return None
        self.current -= 1
        return self.mesh_options[self.current]


def elastic_replan(cfg, shape, new_mesh: MeshSpec,
                   history=None) -> Plan:
    """Re-materialize the same resource graph on a different mesh.

    This is the crux of resource-centric recovery: nothing about the
    application changes -- only the physical materialization."""
    return materialize(cfg, shape, new_mesh, history=history)


class FailureInjector:
    """Deterministic fault injection for tests/benchmarks."""

    def __init__(self, fail_at_steps: Tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.injected: List[int] = []

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.injected.append(step)
            raise RuntimeError(f"injected failure at step {step}")
