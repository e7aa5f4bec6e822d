"""Paged KV cache with history-driven pool sizing: the port's copy of
``repro/serving/kv_cache.py``.

A request's KV footprint is input-dependent (prompt + generation length),
so per-request allocation follows the paper's §9.3 policy: an initial
page grant plus incremental grants on growth, both solved from the
decayed history of observed request lengths (``core/history.py``,
``core/sizing.py``).  Pages are the allocation quantum; the device side
is one ``(pool_pages + 1, PAGE_SIZE, KV, hd)`` tensor per layer indexed
by page tables (``serving/model_runner.py``).

This port carries the *private* pool of one replica, with the
sliding-window ring group (:class:`PageGroups`): a mixed global/local
stack's local layers index their page tensors through a second id space
of the same size (``free_local``), and a request holds at most
``ring_pages`` of those however long it grows.  Left for later slices,
with the features that need them: the prefix-cache lifecycle
(``cow_grant``, ``cache_donate``, ``prefix_detach``), the view-local id
remap of pod-shared pools, and the runtime sanitizer hooks.
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
    fixed ring of ``ceil(window/PAGE_SIZE) + 1`` pages (the window plus
    the page decode is landing in).  The two groups index disjoint page
    tensors, so they are granted from independent id spaces and charged
    separately: on a 5 local : 1 global stack a long request holds
    ``O(length)`` pages on a sixth of its layers and ``O(window)`` on the
    rest."""

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
        """Fixed per-request page count of one local layer's ring."""
        if self.local_layers == 0:
            return 0
        return -(-self.window // PAGE_SIZE) + 1

    @property
    def w_global(self) -> float:
        """Fraction of the per-page device footprint a global page costs."""
        total = self.global_layers + self.local_layers
        return self.global_layers / max(total, 1)

    @property
    def w_local(self) -> float:
        total = self.global_layers + self.local_layers
        return self.local_layers / max(total, 1)


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
    # sliding-window ring pages (only when the pool has a local group);
    # capped at PageGroups.ring_pages regardless of sequence length
    local_pages: List[int] = field(default_factory=list)

    @property
    def length(self) -> int:
        return self.prompt_len + self.generated

    def pages_needed(self, horizon: int = 0) -> int:
        return -(-(self.length + horizon) // PAGE_SIZE)

    def max_pages(self) -> int:
        """Pages needed at completion (prompt fully decoded)."""
        return -(-(self.prompt_len + self.max_new_tokens) // PAGE_SIZE)

    def local_pages_needed(self, groups: PageGroups,
                           horizon: int = 0) -> int:
        """Ring pages a local layer needs at the current length: grows
        like the global table until the ring is full, then stays put."""
        return min(self.pages_needed(horizon), groups.ring_pages)


class PagePool:
    """Fixed pool of KV pages; per-request grants follow the sizing policy."""

    def __init__(self, num_pages: int, history: Optional[HistoryStore] = None,
                 app: str = "serve",
                 policy: str = "history", fixed_init_pages: int = 2,
                 fixed_step_pages: int = 1,
                 groups: Optional[PageGroups] = None):
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
        # per-layer-group accounting (sliding-window rings): the local
        # group's pages index the local layers' own page tensors, so they
        # come from their own id space over the same pool size (the
        # runner's local page tensors are pool-sized, like the global ones)
        self.groups = groups if (groups and groups.local_layers) else None
        self.free_local: Optional[List[int]] = (
            list(range(num_pages)) if self.groups else None)

    def _global_need(self, req: Request, horizon: int = 0) -> int:
        """Pages the growing (global-group) table needs; zero for a stack
        with no global layers at all."""
        if self.groups is not None and self.groups.global_layers == 0:
            return 0
        return req.pages_needed(horizon)

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

    def _alloc_local(self, n: int) -> Optional[List[int]]:
        """Take n ring pages from the local id space."""
        if self.free_local is None or n > len(self.free_local):
            return None
        return [self.free_local.pop() for _ in range(n)]

    def _dealloc_local(self, pages: List[int]) -> None:
        """Return ring pages to the local id space."""
        if pages:
            self.free_local.extend(pages)

    def admissible(self, req: Request) -> bool:
        """False when the request could never complete under the pool's
        hard cap: the engine rejects it instead of retrying forever."""
        need = req.max_pages()
        if self.groups is not None:
            if self.groups.global_layers == 0:
                need = 0
            need = max(need, self.groups.ring_pages)
        if need <= self.num_pages:
            return True
        self.stats["denials"] += 1
        return False

    def _grant_local(self, req: Request, horizon: int = 0) -> bool:
        """Top the ring grant up to what the current length needs (never
        past the ring).  Rolls back nothing itself: callers do."""
        if self.groups is None:
            return True
        need = (req.local_pages_needed(self.groups, horizon)
                - len(req.local_pages))
        if need <= 0:
            return True
        got = self._alloc_local(need)
        if got is None:
            return False
        req.local_pages.extend(got)
        return True

    def try_admit(self, req: Request) -> bool:
        """Initial grant: max(prompt pages, policy init), clamped to the
        pool so a large policy init never denies a servable request, on
        the global table; plus, for sliding-window stacks, the prompt's
        ring pages."""
        if self.groups is not None and self.groups.global_layers == 0:
            want = 0          # pure-local stack: no growing table at all
        else:
            need = self._global_need(req)
            want = max(need, min(max(need, int(self.sizing().init)),
                                 self.num_pages))
        got = self._alloc(want)
        if got is None:
            self.stats["denials"] += 1
            return False
        req.pages = got
        if not self._grant_local(req):
            req.pages = []
            self.free.extend(got)
            self.stats["denials"] += 1
            return False
        req.state = "running"
        self.stats["grants"] += 1
        self.stats["grant_pages"] += want + len(req.local_pages)
        self._solve_counter += 1
        return True

    def grow(self, req: Request, horizon: int = 0) -> bool:
        """Incremental grant when the request outgrows its pages; the
        engine grows with horizon=1 so the next token's write slot is
        always backed by a page.  The groups grow independently: the
        global table keeps extending, the ring stops at ``ring_pages``."""
        held_local = len(req.local_pages)
        if not self._grant_local(req, horizon):
            self.stats["denials"] += 1
            return False
        need = self._global_need(req, horizon) - len(req.pages)
        if need <= 0:
            return True
        want = max(need, min(max(int(self.sizing().step), need),
                             self.num_pages - len(req.pages)))
        got = self._alloc(want)
        if got is None:
            grown = req.local_pages[held_local:]
            del req.local_pages[held_local:]
            self._dealloc_local(grown)
            self.stats["denials"] += 1
            return False
        req.pages.extend(got)
        self.stats["scaleups"] += 1
        return True

    def release(self, req: Request) -> None:
        self.free.extend(req.pages)
        self._dealloc_local(req.local_pages)
        self.stats["released"] += 1
        if self.history is not None:
            self.history.observe(self.history_key, "request", "pages",
                                 max(len(req.pages), 1))
        req.pages = []
        req.local_pages = []
        req.state = "done"

    def reclaim(self, req: Request) -> Tuple[List[int], List[int]]:
        """Return a request's pages WITHOUT completing it (the engine's
        ``drain``): no history sample, since the request resumes with the
        same footprint, and no 'released' count.  Returns the physical
        (global, local-ring) page ids it held; a private pool's ids are
        physical."""
        held, req.pages = req.pages, []
        held_local, req.local_pages = req.local_pages, []
        self.free.extend(held)
        self._dealloc_local(held_local)
        req.state = "parked"
        return list(held), list(held_local)

    def regrant(self, req: Request, n: int, n_local: int = 0) -> bool:
        """Re-grant exactly a drained request's page counts (the sizing
        policy already spoke when the pages were first granted)."""
        got = self._alloc(n)
        if got is None:
            self.stats["denials"] += 1
            return False
        got_local: List[int] = []
        if n_local:
            got_local = self._alloc_local(n_local)
            if got_local is None:
                self.free.extend(got)
                self.stats["denials"] += 1
                return False
        req.pages = got
        req.local_pages = got_local
        req.state = "running"
        return True

    @property
    def physical_pages(self) -> int:
        """Size of the backing physical pool (the runner's page-array dim)."""
        return self.num_pages

    @property
    def used_local(self) -> int:
        """Ring pages held (0 without a local group)."""
        if self.free_local is None:
            return 0
        return self.num_pages - len(self.free_local)

    @property
    def utilization(self) -> float:
        """Fraction of the pool's page-layer slots in use.  With layer
        groups each group's usage is weighted by the fraction of layers
        its pages occupy, so a sliding-window stack's bounded rings show
        up as the lower footprint they are."""
        used_g = self.num_pages - len(self.free)
        if self.groups is None:
            return used_g / max(self.num_pages, 1)
        return ((self.groups.w_global * used_g
                 + self.groups.w_local * self.used_local)
                / max(self.num_pages, 1))


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
