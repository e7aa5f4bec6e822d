"""Multi-tenant KV-page sharing: one physical pool per pod, many apps.
A copy of ``repro/serving/tenancy.py``, with the runtime sanitizer's
hooks (``repro_torch.analysis.zensan``) where the reference has them; on
the card a ``KVArrayStore``'s page tensors are the pod's device memory
for one KV shape.

The paper's resource-centric claim (§9.3) is that co-located applications
share a pod's memory through history-driven per-request grants instead of
each bringing a peak-provisioned private pool.  This module is the serving
instantiation of that claim:

* :class:`SharedPagePool` -- the single physical page pool of one pod.
  It owns the free list, tracks per-app usage, and arbitrates *cross-app*
  preemption: when any tenant is out of pages, the victim is taken from
  the application furthest over its weighted fair share (not merely the
  requester's own newest request).
* :class:`PoolView` -- one application's window onto the shared pool.  It
  IS a :class:`~repro_torch.serving.kv_cache.PagePool` as far as the
  :class:`~repro_torch.serving.engine.ServingEngine` is concerned (same
  try_admit / grow / release / sizing surface, per-app history-driven
  grant policy), but physical pages come from the shared pool and are
  capped by the view's quota.

Physical aliasing: requests on a PoolView carry *view-local* page ids;
the view owns a logical->physical remap onto ids drawn from the shared
free list.  Same-KV-shape paged tenants bind one
:class:`~repro_torch.serving.model_runner.KVArrayStore` (registered here per
shape key) and so read/write the pod's ONE device page-array set --
preemption, ``resize_quota`` shrink, and parking move *real* pages
between applications, not just accounting.  The remap is also the
isolation boundary: translating an id the view no longer owns raises,
so no tenant can read a page that was reclaimed from it.

Quotas: ``quota`` may be an explicit page count (hard cap), the string
``"fair"`` (dynamic weighted fair share, recomputed as tenants come and
go), or None (work-conserving: an idle pool may be fully consumed by one
tenant; the fair-share preemption policy claws pages back under
contention).  Per-request grant sizes remain history-driven per app via
the §9.3 sizing program, keyed by the view's app name.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis import zensan
from repro_torch.core.history import HistoryStore
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.kv_cache import PageGroups, PagePool


class SharedPagePool:
    """One pod's physical KV page pool, shared by N serving applications."""

    def __init__(self, num_pages: int,
                 history: Optional[HistoryStore] = None):
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages))
        self.history = history
        self.views: Dict[str, "PoolView"] = {}
        self.stats = {"preemptions": {}, "cross_app_preemptions": 0,
                      "denials": {}, "prefix_evictions": 0}
        # physical KV device-array sets, one per KV shape signature: every
        # same-shape paged tenant aliases the same arrays (see kv_store)
        self.kv_stores: Dict[Tuple, object] = {}
        # global prefix caches, keyed (kv_shape_key, model, seed): tenants
        # may share cached prefix pages only when they share BOTH the
        # device arrays and the weights that produced the KV
        self.prefix_caches: Dict[Tuple, object] = {}

    # -- tenancy ------------------------------------------------------------
    def view(self, app: str, *,
             quota: Union[int, str, None] = None, weight: float = 1.0,
             policy: str = "history", fixed_init_pages: int = 2,
             fixed_step_pages: int = 1,
             groups: Optional[PageGroups] = None,
             history_key: Optional[str] = None) -> "PoolView":
        """The (single) view of one application; app names must be unique
        per pod -- a live duplicate would merge two engines' page
        accounting onto one quota and corrupt victim selection.  Replica
        views of one app carry suffixed names (``app@rN``) but pass the
        bare app name as ``history_key`` so sizing history stays one
        per-application series."""
        v = self.views.get(app)
        if v is not None:
            if v.engine is not None:
                raise ValueError(
                    f"serve application {app!r} is already live on this "
                    "pod's shared pool: give each serve Application a "
                    "unique name=")
            if groups is not None:
                v.set_groups(groups)
            return v
        v = PoolView(self, app, quota=quota, weight=weight,
                     policy=policy, fixed_init_pages=fixed_init_pages,
                     fixed_step_pages=fixed_step_pages, groups=groups)
        if history_key is not None:
            v.history_key = history_key
        self.views[app] = v
        return v

    def _take(self, n: int) -> Optional[List[int]]:
        if n > len(self.free):
            # pool pressure: evict refcount-0 prefix-cache pages (global
            # LRU across every cache on this pod) before denying.  Pinned
            # nodes -- prefixes some in-flight request decodes through --
            # are never victims; live requests always outrank cold cache.
            self._evict_prefix(n - len(self.free))
        if n > len(self.free):
            return None
        got = [self.free.pop() for _ in range(n)]
        s = zensan.SAN
        if s is not None:
            s.take(self, got)
        return got

    def _give(self, pages: List[int]) -> None:
        s = zensan.SAN
        if s is not None:
            s.give(self, pages)
        self.free.extend(pages)

    def _evict_prefix(self, need: int) -> int:
        """Evict up to ``need`` refcount-0 cached pages, oldest first
        across all of the pod's prefix caches; freed pages land back on
        ``self.free`` via each cache's free_fn (:meth:`_give`)."""
        freed = 0
        while freed < need:
            best = None
            for c in self.prefix_caches.values():
                n = c.peek_evictable()
                if n is not None and (best is None
                                      or n.last_used < best[1].last_used):
                    best = (c, n)
            if best is None:
                break
            freed += len(best[0].evict(best[1]))
        self.stats["prefix_evictions"] += freed
        if freed:
            t = obs_trace.TRACER
            if t is not None:
                t.instant("pool", "evict", None,
                          {"pages": freed, "kind": "prefix"})
        return freed

    # -- physical KV device arrays (same-shape tenant aliasing) --------------
    def kv_store(self, key: Tuple, factory: Callable[[], object]) -> object:
        """The pod's single physical KV array set for ``key`` (a KV shape
        signature -- see :func:`repro_torch.serving.model_runner.kv_shape_key`).
        Created by ``factory`` on the first same-shape paged tenant and
        aliased by every later one; dropped when the last aliasing view
        closes.  Tenants whose shape has no registered twin simply get a
        fresh store: mismatched-shape tenants therefore never alias."""
        st = self.kv_stores.get(key)
        if st is None:
            st = factory()
            self.kv_stores[key] = st
        return st

    # -- global prefix caches (serving/prefix_cache.py) ----------------------
    def prefix_cache(self, key: Tuple, factory: Callable[[], object]):
        """The pod's single prefix cache for ``key`` -- ``(kv_shape_key,
        model_name, seed)``: cached KV is a function of the weights, not
        just the array shapes, so only true model twins may share.
        Created on first use; survives app churn (a future same-key
        tenant re-warms instantly) but is flushed with its KV store."""
        c = self.prefix_caches.get(key)
        if c is None:
            c = factory()
            self.prefix_caches[key] = c
        return c

    def flush_prefix_caches(self, kv_key: Tuple) -> int:
        """Evict every unpinned node of the caches bound to KV store
        ``kv_key`` -- called when the store's device arrays go away
        (last tenant closed, or all tenants parked): the cached pages'
        contents die with the arrays, so the index must not outlive
        them.  Returns pages freed."""
        freed = 0
        for key in [k for k in self.prefix_caches
                    if k and k[0] == kv_key]:
            cache = self.prefix_caches[key]
            freed += cache.flush()
            if cache.num_pages == 0:
                self.prefix_caches.pop(key, None)
        return freed

    def kv_device_bytes(self) -> int:
        """Live device bytes of every registered KV array store (the pod's
        REAL paged-KV HBM footprint, as opposed to the accounted pages)."""
        return sum(int(st.device_bytes()) for st in self.kv_stores.values())

    # -- accounting ---------------------------------------------------------
    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self.free)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / max(self.num_pages, 1)

    def fair_share(self, view: "PoolView") -> float:
        """Parked views drop out of the share computation: a parked app
        holds no pages and must not dilute active tenants' shares."""
        if view.parked:
            return 0.0
        total = sum(v.weight for v in self.views.values()
                    if not v.parked) or 1.0
        return self.num_pages * view.weight / total

    # -- cross-app preemption (the tenancy policy) --------------------------
    def select_victim_view(self) -> Optional["PoolView"]:
        """The app furthest over its weighted fair share that still has a
        running request to give back."""
        best, best_over = None, None
        for v in self.views.values():
            if v.parked or v.engine is None or not v.engine.running:
                continue
            over = v.used - self.fair_share(v)
            if best_over is None or over > best_over:
                best, best_over = v, over
        return best

    def preempt_for(self, requester: "PoolView") -> bool:
        """Free pages for ``requester`` by preempting the newest request of
        the most over-share app (possibly the requester itself).  Returns
        True when a preemption happened."""
        victim_view = self.select_victim_view()
        if victim_view is None:
            return False
        if not victim_view.engine.preempt_newest():
            return False
        p = self.stats["preemptions"]
        p[victim_view.app] = p.get(victim_view.app, 0) + 1
        if victim_view is not requester:
            self.stats["cross_app_preemptions"] += 1
        t = obs_trace.TRACER
        if t is not None:
            t.instant("pool", "preempt_cross", requester.app,
                      {"victim": victim_view.app,
                       "cross": victim_view is not requester})
        return True


class PoolView(PagePool):
    """One application's quota-capped window onto a :class:`SharedPagePool`.

    Engine-compatible: grants and releases go through the PagePool logic
    (history-driven sizing per app), but the physical free list belongs to
    the shared pool and allocation is denied beyond this view's quota.

    Requests on a view hold **view-local** page ids; ``_remap`` (and
    ``_remap_local`` for sliding-window rings) translates them to the
    physical ids actually drawn from the shared free list.  The paged
    runner calls :meth:`to_physical` at kernel time, so when same-shape
    tenants alias one :class:`KVArrayStore` the device page arrays are
    indexed by pod-unique physical ids while each app's page tables stay
    in its own id space.  Translation of an id the view no longer owns
    raises -- the isolation guard preemption and quota shrink rely on.
    """

    def __init__(self, shared: SharedPagePool, app: str, *,
                 quota: Union[int, str, None] = None, weight: float = 1.0,
                 policy: str = "history", fixed_init_pages: int = 2,
                 fixed_step_pages: int = 1,
                 groups: Optional[PageGroups] = None):
        super().__init__(0, history=shared.history, app=app, policy=policy,
                         fixed_init_pages=fixed_init_pages,
                         fixed_step_pages=fixed_step_pages)
        self.shared = shared
        self.weight = float(weight)
        self._quota = quota
        self.used = 0
        self._used_local = 0
        self.engine = None              # set by ServingEngine.attach
        self.parked = False             # set by autoscale/parking.py
        self.free = []                  # unused: physical list is shared
        self._denial_cause = "physical"
        # view-local id space: requests see small stable ids, the view
        # remembers which physical page backs each (recycled on dealloc)
        self.kv_store = None            # bound via bind_kv_store (aliasing)
        self._remap: Dict[int, int] = {}
        self._remap_local: Dict[int, int] = {}
        self._free_ids: List[int] = []
        self._free_ids_local: List[int] = []
        self._next_id = 0
        self._next_id_local = 0
        if groups is not None:
            self.set_groups(groups)

    def _local_space(self) -> int:
        # the local (ring) physical space indexes pool-sized per-layer
        # arrays (shared store's or the app's own); its size is the pod
        # pool's physical size, not this view's (dynamic) quota
        return self.shared.num_pages

    # -- quota --------------------------------------------------------------
    @property
    def quota(self) -> int:
        """Effective hard cap in pages for this app."""
        if self._quota is None:
            return self.shared.num_pages          # work-conserving
        if self._quota == "fair":
            return max(int(self.shared.fair_share(self)), 1)
        return int(self._quota)

    def _page_cap(self) -> int:
        return min(self.quota, self.shared.num_pages)

    def resize_quota(self, quota: Union[int, str, None]) -> int:
        """Runtime quota change (the autoscale rebalancer's lever).

        Shrinking below current usage drains the overage through the
        engine's normal preemption path -- preempted requests release
        their pages to the shared pool and re-queue (at-least-once), so
        pages are never stranded on an over-quota view.  When the view
        aliases a shared KV array store the drained pages are *physical*:
        they become grantable to co-tenants in the same tick, and this
        view's remap forgets them (reading one raises).  Returns the
        number of requests preempted by the shrink."""
        self._quota = quota
        preempted = 0
        while self.used > self.quota or self.used_local > self.quota:
            if self.engine is None or not self.engine.preempt_newest():
                break          # no running request left to give back
            preempted += 1
        return preempted

    def admissible(self, req) -> bool:
        ok = super().admissible(req)
        if not ok:
            self._note_denial()
        return ok

    # -- view-local id space -------------------------------------------------
    def _new_ids(self, n: int, local: bool = False) -> List[int]:
        """n fresh view-local ids (recycled before the counter grows, so
        the id space stays as small as the view's peak usage)."""
        free = self._free_ids_local if local else self._free_ids
        ids = []
        for _ in range(n):
            if free:
                ids.append(free.pop())
            elif local:
                ids.append(self._next_id_local)
                self._next_id_local += 1
            else:
                ids.append(self._next_id)
                self._next_id += 1
        return ids

    def to_physical(self, ids: Sequence[int]) -> List[int]:
        """Physical page ids backing the view-local ``ids``.  Raises on
        any id this view does not currently own -- after preemption,
        quota shrink, or parking the physical page may already belong to
        a co-tenant, and reading it would leak another app's KV."""
        try:
            return [self._remap[v] for v in ids]
        except KeyError as e:
            raise KeyError(
                f"view {self.app!r} does not own page id {e.args[0]}: the "
                "physical page was reclaimed (isolation guard)") from None

    def to_physical_local(self, ids: Sequence[int]) -> List[int]:
        try:
            return [self._remap_local[v] for v in ids]
        except KeyError as e:
            raise KeyError(
                f"view {self.app!r} does not own ring page id {e.args[0]}: "
                "the physical page was reclaimed (isolation guard)") from None

    # -- physical KV array aliasing ------------------------------------------
    def bind_kv_store(self, store) -> None:
        """Alias this view onto the pod's shared device arrays for its KV
        shape (a :class:`~repro_torch.serving.model_runner.KVArrayStore` from
        ``SharedPagePool.kv_store``).  Ring (local-group) pages then come
        from the store's shared local free list instead of a per-view
        space, since the local-layer arrays are shared too.  Must happen
        before any page is granted: the local id spaces differ."""
        if self.used or self.used_local:
            raise RuntimeError(
                f"view {self.app!r}: bind_kv_store with pages outstanding")
        self.kv_store = store
        store.users.add(self.app)

    def _local_free(self) -> Optional[List[int]]:
        """The physical free list ring pages draw from: the aliased
        store's shared one, else this view's private space."""
        if self.kv_store is not None and self.kv_store.free_local is not None:
            return self.kv_store.free_local
        return self.free_local

    # -- physical allocation via the shared pool ----------------------------
    def _alloc(self, n: int) -> Optional[List[int]]:
        if self.used + n > self.quota:
            self._denial_cause = "quota"
            self._note_denial()
            return None
        got = self.shared._take(n)
        if got is None:
            self._denial_cause = "physical"
            self._note_denial()
            return None
        self.used += n
        ids = self._new_ids(n)
        for vid, pid in zip(ids, got):
            self._remap[vid] = pid
        s = zensan.SAN
        if s is not None:
            s.grant(self, ids, got)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("pool", "grant", self.app,
                      {"pages": n, "used": self.used})
        return ids

    def _dealloc(self, pages: List[int]) -> None:
        self.used -= len(pages)
        phys = [self._remap.pop(v) for v in pages]
        self._free_ids.extend(pages)
        s = zensan.SAN
        if s is not None:
            s.release(self, pages, phys)
        self.shared._give(phys)

    def cache_donate(self, pages: Sequence[int]) -> List[int]:
        """Donate freshly prefilled prompt pages to the prefix cache:
        uncharge this view's quota and forget the remap (the request
        will reference the pages by PHYSICAL id via ``shared_pages``),
        but do NOT return them to the shared free list -- the cache owns
        them now, and pod-level used_pages keeps reporting them."""
        self.used -= len(pages)
        phys = [self._remap.pop(v) for v in pages]
        self._free_ids.extend(pages)
        s = zensan.SAN
        if s is not None:
            s.cache_donated(self, phys, self.prefix_cache)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("pool", "cache_donate", self.app,
                      {"pages": len(pages)})
        return phys

    def _alloc_local(self, n: int) -> Optional[List[int]]:
        """Ring pages index the local-attention layers' arrays -- the
        aliased store's shared ones, else the app's private set -- and
        still count against this view's quota: the quota caps each layer
        group's table independently."""
        src = self._local_free()
        if src is None:
            return None
        if self._used_local + n > self.quota:
            self._denial_cause = "quota"
            self._note_denial()
            return None
        if n > len(src):
            self._denial_cause = "physical"
            self._note_denial()
            return None
        self._used_local += n
        got = [src.pop() for _ in range(n)]
        ids = self._new_ids(n, local=True)
        for vid, pid in zip(ids, got):
            self._remap_local[vid] = pid
        s = zensan.SAN
        if s is not None:
            s.grant_local(self, got)
        return ids

    def _dealloc_local(self, pages: List[int]) -> None:
        if pages:
            self._used_local -= len(pages)
            phys = [self._remap_local.pop(v) for v in pages]
            self._free_ids_local.extend(pages)
            s = zensan.SAN
            if s is not None:
                s.release_local(self, phys)
            self._local_free().extend(phys)

    def _note_denial(self) -> None:
        d = self.shared.stats["denials"]
        d[self.app] = d.get(self.app, 0) + 1
        t = obs_trace.TRACER
        if t is not None:
            t.instant("pool", "denial", self.app,
                      {"cause": self._denial_cause})

    # -- engine hooks --------------------------------------------------------
    def attach(self, engine) -> None:
        self.engine = engine

    def preempt_any(self) -> bool:
        """Engine pressure hook.  A *physical* shortage is arbitrated
        across ALL of the pod's apps (fair-share victim selection); a
        *quota* denial can never be lifted by freeing co-tenants' pages,
        so the app sheds its own load instead of punishing neighbours."""
        if self._denial_cause == "quota":
            return self.engine is not None and self.engine.preempt_newest()
        return self.shared.preempt_for(self)

    def close(self) -> None:
        """Detach this app from the pod pool (on application release).
        The last aliasing tenant of a KV array store takes the store --
        and its device HBM -- with it."""
        s = zensan.SAN
        if s is not None:
            s.view_closed(self)
        self.engine = None
        if self.kv_store is not None:
            st = self.kv_store
            st.users.discard(self.app)
            if not st.users:
                # cached prefix pages live inside the store's arrays --
                # flush them back to the shared free list before the
                # arrays (and their content) go away; the tensors are
                # dropped here, not when the last runner referencing the
                # store is collected, so the device memory comes back now
                self.shared.flush_prefix_caches(st.key)
                self.shared.kv_stores.pop(st.key, None)
                st.drop_arrays()
            elif all(getattr(self.shared.views.get(u), "parked", False)
                     for u in st.users):
                # every remaining tenant is parked (KV on host): the
                # store stays registered for their unpark to revive, but
                # its device memory must not sit idle meanwhile
                self.shared.flush_prefix_caches(st.key)
                st.drop_arrays()
            self.kv_store = None
        self.shared.views.pop(self.app, None)

    # -- accounting ---------------------------------------------------------
    @property
    def num_pages(self) -> int:          # engine/pretty-print compatibility
        return self.quota

    @num_pages.setter
    def num_pages(self, v: int) -> None:
        pass                             # base __init__ assigns; quota rules

    @property
    def physical_pages(self) -> int:
        return self.shared.num_pages

    @property
    def used_local(self) -> int:
        """Ring pages this view holds."""
        return self._used_local

    @property
    def utilization(self) -> float:
        if self.groups is None:
            return self.used / max(self.quota, 1)
        return ((self.groups.w_global * self.used
                 + self.groups.w_local * self.used_local)
                / max(self.quota, 1))
