"""Paged KV cache with history-driven pool sizing: the port's copy of
``repro/serving/kv_cache.py``.

A request's KV footprint is input-dependent (prompt + generation length),
so per-request allocation follows the paper's §9.3 policy: an initial
page grant plus incremental grants on growth, both solved from the
decayed history of observed request lengths (``core/history.py``,
``core/sizing.py``).  Pages are the allocation quantum; the device side
is one ``(pool_pages + 1, PAGE_SIZE, KV, hd)`` tensor per layer indexed
by page tables (``serving/model_runner.py``).

:class:`PagePool` is one replica's private pool, and the base of the
pod-shared pool's per-app view (``serving/tenancy.py``'s ``PoolView``,
which overrides the physical allocation primitives and the id
translation).  The sliding-window ring group (:class:`PageGroups`) gives
a mixed global/local stack's local layers a second id space of the same
size (``free_local``); a request holds at most ``ring_pages`` of those
however long it grows.  The prefix-cache lifecycle (``cow_grant``,
``cache_donate``, ``prefix_detach``, refcount-0 eviction in ``_alloc``)
serves ``serving/prefix_cache.py``.  The reference's runtime sanitizer
hooks (``repro_torch.analysis.zensan``) sit where the reference has them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis import zensan
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
    state: str = "queued"     # queued|running|done|rejected|parked
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
    # -- global prefix cache (serving/prefix_cache.py) -----------------------
    # PHYSICAL page ids of the read-only cached-prefix pages this request
    # references (never view-local: cache pages belong to no view).  They
    # lead the decode page table, ahead of the view-translated private
    # pages, and are not charged to the request's quota.
    shared_pages: List[int] = field(default_factory=list)
    # prompt tokens covered by the cache at attach time (prefill skips them)
    cached_len: int = 0
    # physical page to copy-on-write the partial lead from (cached_len %
    # PAGE_SIZE tokens land in the request's first private page)
    cow_src_page: Optional[int] = None
    # pinned PrefixNode chain; the pool unpins on release/reclaim
    prefix_nodes: Optional[list] = None
    # how many shared pages a drained request must re-pin to resume
    parked_shared: int = 0

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
                      "scaleups": 0, "released": 0, "prefix_unpinned": 0,
                      "prefix_evictions": 0}
        # bound by the executor when the app opts into prefix caching; a
        # private pool owns its cache outright, a PoolView aliases the
        # pod-level one registered on the SharedPagePool
        self.prefix_cache = None
        # per-layer-group accounting (sliding-window rings): the local
        # group's pages index the local layers' own page tensors, so they
        # come from their own id space
        self.groups = None
        self.free_local: Optional[List[int]] = None
        if groups is not None:
            self.set_groups(groups)

    def set_groups(self, groups: Optional[PageGroups]) -> None:
        """Attach (or refresh) the layer-group split.  Must happen while
        no request holds pages: the id spaces are being (re)defined."""
        self.groups = groups if (groups and groups.local_layers) else None
        self.free_local = (list(range(self._local_space()))
                           if self.groups else None)

    def _local_space(self) -> int:
        """Size of the local-group page-id space (the runner's local page
        tensors are pool-sized, like the global ones)."""
        return self.num_pages

    def _global_need(self, req: Request, horizon: int = 0) -> int:
        """PRIVATE pages the growing (global-group) table needs; zero for
        a stack with no global layers at all.  Prefix-cache shared pages
        already back the leading table entries, so they are not charged
        to the request (or its view's quota) again."""
        if self.groups is not None and self.groups.global_layers == 0:
            return 0
        return max(req.pages_needed(horizon) - len(req.shared_pages), 0)

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

    # -- physical allocation primitives (overridden by tenancy.PoolView) ----
    def _alloc(self, n: int) -> Optional[List[int]]:
        """Take n physical pages, or None when they cannot be granted.
        Under pool pressure refcount-0 prefix-cache pages are the first
        victims (LRU): cold cached prefixes yield to live requests, but
        pinned nodes are never touched."""
        if n > len(self.free) and self.prefix_cache is not None:
            freed = self.prefix_cache.evict_lru(n - len(self.free))
            self.stats["prefix_evictions"] += freed
        if n > len(self.free):
            return None
        got = [self.free.pop() for _ in range(n)]
        s = zensan.SAN
        if s is not None:
            # a private pool's ids are physical AND request-visible:
            # take+grant collapse into one step (no remap in between)
            s.take(self, got)
            s.grant(self, got, got)
        return got

    def _dealloc(self, pages: List[int]) -> None:
        s = zensan.SAN
        if s is not None:
            s.release(self, pages, pages)
            s.give(self, pages)
        self.free.extend(pages)

    def _give(self, pages: List[int]) -> None:
        """Return PHYSICAL pages straight to the free list: the prefix
        cache's eviction path (cache pages were donated out of request
        accounting, so they come back without touching it)."""
        s = zensan.SAN
        if s is not None:
            s.give(self, pages)
        self.free.extend(pages)

    def _alloc_local(self, n: int) -> Optional[List[int]]:
        """Take n ring pages from the local id space."""
        if self.free_local is None or n > len(self.free_local):
            return None
        got = [self.free_local.pop() for _ in range(n)]
        s = zensan.SAN
        if s is not None:
            s.grant_local(self, got)
        return got

    def _dealloc_local(self, pages: List[int]) -> None:
        """Return ring pages to the local id space."""
        if pages:
            s = zensan.SAN
            if s is not None:
                s.release_local(self, pages)
            self.free_local.extend(pages)

    def _page_cap(self) -> int:
        """Hard page ceiling a single request can ever hold."""
        return self.num_pages

    # -- prefix-cache lifecycle (serving/prefix_cache.py) --------------------
    def cow_grant(self) -> Optional[List[int]]:
        """One page for a copy-on-write split: the caller copies a cached
        page's lead slots here before writing past them.  Returns the
        granted id list (view-local under a PoolView), or None under
        pressure."""
        return self._alloc(1)

    def cache_donate(self, ids: Sequence[int]) -> List[int]:
        """Move pages out of request accounting into prefix-cache
        ownership, returning their PHYSICAL ids.  A private pool's ids
        are physical and the pages simply stay off the free list (the
        cache's ``free_fn`` puts them back on eviction); a PoolView also
        uncharges its quota and forgets the remap."""
        phys = list(ids)
        s = zensan.SAN
        if s is not None:
            s.cache_donated(self, phys, self.prefix_cache)
        return phys

    def prefix_detach(self, req: Request, keep: bool = False) -> int:
        """Unpin a request's prefix-cache nodes (idempotent).  Returns
        how many nodes dropped to refcount 0, folded into stats.  With
        ``keep`` (a drain) the bookkeeping needed to re-attach survives;
        otherwise the request forgets its cached prefix entirely."""
        released = 0
        if req.prefix_nodes and self.prefix_cache is not None:
            released = self.prefix_cache.unpin(req.prefix_nodes)
            self.stats["prefix_unpinned"] += released
        req.prefix_nodes = None
        req.shared_pages = []
        req.cow_src_page = None
        if not keep:
            req.cached_len = 0
            req.parked_shared = 0
        return released

    # -- id translation (overridden by tenancy.PoolView) ---------------------
    def to_physical(self, ids: Sequence[int]) -> List[int]:
        """Physical page ids backing ``ids``.  A private pool's ids ARE
        physical (they index the runner's own pool-sized tensors); a
        ``PoolView`` stores view-local ids on requests and remaps them
        onto the pod's shared page tensors here."""
        return list(ids)

    def to_physical_local(self, ids: Sequence[int]) -> List[int]:
        """Physical ids of local-group (sliding-window ring) pages."""
        return list(ids)

    def admissible(self, req: Request) -> bool:
        """False when the request could never complete under the pool's
        hard cap: the engine rejects it instead of retrying forever."""
        need = req.max_pages()
        if self.groups is not None:
            if self.groups.global_layers == 0:
                need = 0
            need = max(need, self.groups.ring_pages)
        if need <= self._page_cap():
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
                                 self._page_cap()))
        got = self._alloc(want)
        if got is None:
            self.stats["denials"] += 1
            return False
        req.pages = got
        if not self._grant_local(req):
            req.pages = []
            self._dealloc(got)
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
                             self._page_cap() - len(req.pages)))
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
        self.prefix_detach(req)
        self._dealloc(req.pages)
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
        same footprint, and no 'released' count.  Returns the PHYSICAL
        (global, local-ring) page ids it held, translated before the ids
        are freed (a PoolView forgets the remap on dealloc), so the
        drained KV can be gathered and restored into fresh grants.  The
        shared prefix pages are unpinned (``parked_shared`` remembers how
        many to re-pin: ``PagedRunner.prefix_reattach``)."""
        held, req.pages = req.pages, []
        held_local, req.local_pages = req.local_pages, []
        phys = self.to_physical(held)
        phys_local = self.to_physical_local(held_local)
        self._dealloc(held)
        self._dealloc_local(held_local)
        req.parked_shared = len(req.shared_pages)
        self.prefix_detach(req, keep=True)
        req.state = "parked"
        s = zensan.SAN
        if s is not None:
            s.parked(self, req.req_id, len(phys), len(phys_local))
        return phys, phys_local

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
                self._dealloc(got)
                self.stats["denials"] += 1
                return False
        req.pages = got
        req.local_pages = got_local
        req.state = "running"
        s = zensan.SAN
        if s is not None:
            s.regranted(self, req.req_id, n, n_local)
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
        return self._local_space() - len(self.free_local)

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
    ``pages`` overrides each request's id list (the runner passes the
    physical ids: shared prefix pages, then ``pool.to_physical``)."""
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
