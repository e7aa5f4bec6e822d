"""Paged KV cache with history-driven pool sizing: the port's copy of
``repro/serving/kv_cache.py``.

A request's KV footprint is input-dependent (prompt + generation length),
so per-request allocation follows the paper's §9.3 policy: an initial
page grant plus incremental grants on growth, both solved from the
decayed history of observed request lengths (``core/history.py``,
``core/sizing.py``).  Pages are the allocation quantum; the device side
is one ``(pool_pages + 1, PAGE_SIZE, KV, hd)`` tensor per layer indexed
by page tables (``serving/model_runner.py``).

This port carries the *private* pool of one replica.  Left for later
slices, with the features that need them: the sliding-window ring id
space (``PageGroups`` is here so the runner can refuse ring stacks), the
prefix-cache lifecycle (``cow_grant``, ``cache_donate``,
``prefix_detach``), the view-local id remap of pod-shared pools, and the
runtime sanitizer hooks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ATTN_LOCAL
from repro_torch.core.history import HistoryStore
from repro_torch.core.sizing import SizingSolution, solve_init_step

PAGE_SIZE = 128  # tokens per page


@dataclass(frozen=True)
class PageGroups:
    """Per-layer-kind page accounting of a mixed global/sliding-window
    stack: global layers keep a growing table, sliding-window layers a
    fixed ring of ``ceil(window/PAGE_SIZE) + 1`` pages."""

    global_layers: int
    local_layers: int
    window: int

    @classmethod
    def from_config(cls, cfg) -> "PageGroups":
        n_local = sum(1 for k in cfg.pattern if k == ATTN_LOCAL)
        return cls(global_layers=len(cfg.pattern) - n_local,
                   local_layers=n_local,
                   window=cfg.sliding_window if n_local else 0)

    @property
    def ring_pages(self) -> int:
        if self.local_layers == 0:
            return 0
        return -(-self.window // PAGE_SIZE) + 1


@dataclass
class Request:
    req_id: str
    prompt_len: int
    max_new_tokens: int
    generated: int = 0
    pages: List[int] = field(default_factory=list)
    state: str = "queued"     # queued|running|done|rejected
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    # completed output (prefill token + decoded tokens); the runner hands
    # ownership back here on completion
    output_tokens: Optional[List[int]] = None
    # explicit prompt (parity tests pass the same tokens to both
    # packages); when None the runner synthesizes from req_id
    prompt_tokens: Optional[Tuple[int, ...]] = None

    @property
    def length(self) -> int:
        return self.prompt_len + self.generated

    def pages_needed(self, horizon: int = 0) -> int:
        return -(-(self.length + horizon) // PAGE_SIZE)

    def max_pages(self) -> int:
        """Pages needed at completion (prompt fully decoded)."""
        return -(-(self.prompt_len + self.max_new_tokens) // PAGE_SIZE)


class PagePool:
    """Fixed pool of KV pages; per-request grants follow the sizing policy."""

    def __init__(self, num_pages: int, history: Optional[HistoryStore] = None,
                 app: str = "serve",
                 policy: str = "history", fixed_init_pages: int = 2,
                 fixed_step_pages: int = 1):
        if policy not in ("history", "fixed", "peak"):
            raise ValueError(f"unknown sizing policy {policy!r}")
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages))
        self.history = history
        self.app = app
        # sizing-history identity: replicas of one app carry distinct view
        # names (``app``) but must read/write ONE per-app history series
        self.history_key = app
        self.policy = policy
        self.fixed = (fixed_init_pages, fixed_step_pages)
        self._sizing: Optional[SizingSolution] = None
        self._solve_counter = 0
        self.stats = {"grants": 0, "grant_pages": 0, "denials": 0,
                      "scaleups": 0, "released": 0}

    # -- sizing policy ------------------------------------------------------
    def sizing(self) -> SizingSolution:
        if self.policy == "fixed":
            return SizingSolution(self.fixed[0], self.fixed[1], 0, 0, 0, True)
        if self._sizing is None or self._solve_counter >= 1000:
            self._solve_counter = 0
            hist = []
            if self.history is not None:
                h = self.history.get(self.history_key, "request", "pages")
                if h is not None:
                    hist = h.samples()
            if self.policy == "peak":
                peak = max((v for v, _ in hist), default=4.0)
                self._sizing = SizingSolution(peak, 1, peak, 0, 0, True)
            else:
                self._sizing = solve_init_step(hist, quantum=1.0)
        return self._sizing

    # -- allocation ---------------------------------------------------------
    def _alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self.free):
            return None
        return [self.free.pop() for _ in range(n)]

    def admissible(self, req: Request) -> bool:
        """False when the request could never complete under the pool's
        hard cap: the engine rejects it instead of retrying forever."""
        if req.max_pages() <= self.num_pages:
            return True
        self.stats["denials"] += 1
        return False

    def try_admit(self, req: Request) -> bool:
        """Initial grant: max(prompt pages, policy init), clamped to the
        pool so a large policy init never denies a servable request."""
        need = req.pages_needed()
        want = max(need, min(max(need, int(self.sizing().init)),
                             self.num_pages))
        got = self._alloc(want)
        if got is None:
            self.stats["denials"] += 1
            return False
        req.pages = got
        req.state = "running"
        self.stats["grants"] += 1
        self.stats["grant_pages"] += want
        self._solve_counter += 1
        return True

    def grow(self, req: Request, horizon: int = 0) -> bool:
        """Incremental grant when the request outgrows its pages; the
        engine grows with horizon=1 so the next token's write slot is
        always backed by a page."""
        need = req.pages_needed(horizon) - len(req.pages)
        if need <= 0:
            return True
        want = max(need, min(max(int(self.sizing().step), need),
                             self.num_pages - len(req.pages)))
        got = self._alloc(want)
        if got is None:
            self.stats["denials"] += 1
            return False
        req.pages.extend(got)
        self.stats["scaleups"] += 1
        return True

    def release(self, req: Request) -> None:
        self.free.extend(req.pages)
        self.stats["released"] += 1
        if self.history is not None:
            self.history.observe(self.history_key, "request", "pages",
                                 max(len(req.pages), 1))
        req.pages = []
        req.state = "done"

    def reclaim(self, req: Request) -> Tuple[List[int], List[int]]:
        """Return a request's pages WITHOUT completing it (the engine's
        ``drain``): no history sample, since the request resumes with the
        same footprint, and no 'released' count.  Returns the physical
        (global, local-ring) page ids it held; a private pool's ids are
        physical and it has no ring pages."""
        held, req.pages = req.pages, []
        self.free.extend(held)
        req.state = "parked"
        return list(held), []

    def regrant(self, req: Request, n: int, n_local: int = 0) -> bool:
        """Re-grant exactly a drained request's page count (the sizing
        policy already spoke when the pages were first granted).  A
        private pool has no ring pages, so ``n_local`` must be 0."""
        if n_local:
            raise ValueError("a private pool has no ring pages to regrant")
        got = self._alloc(n)
        if got is None:
            self.stats["denials"] += 1
            return False
        req.pages = got
        req.state = "running"
        return True

    @property
    def physical_pages(self) -> int:
        """Size of the backing physical pool (the runner's page-array dim)."""
        return self.num_pages

    @property
    def utilization(self) -> float:
        return (self.num_pages - len(self.free)) / max(self.num_pages, 1)


def page_table(requests: Sequence[Request], max_pages: int,
               pages: Optional[Sequence[Sequence[int]]] = None) -> np.ndarray:
    """(B, max_pages) int32 page table (-1 padded) for the decode kernel;
    ``pages`` overrides each request's id list."""
    out = np.full((len(requests), max_pages), -1, np.int32)
    for i, r in enumerate(requests):
        ids = r.pages if pages is None else pages[i]
        n = min(len(ids), max_pages)
        out[i, :n] = ids[:n]
    return out


def pool_pages_for_budget(hbm_bytes: int, num_layers: int, kv_dim: int,
                          bytes_per: int = 2) -> int:
    """How many pages fit a device-memory budget (both K and V)."""
    per_page = 2 * PAGE_SIZE * kv_dim * bytes_per * num_layers
    return max(int(hbm_bytes // per_page), 1)
