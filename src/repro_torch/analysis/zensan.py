"""zensan: shadow-ledger sanitizer for the port's paged KV data plane.

The port's copy of ``repro/analysis/zensan.py``: the same hooks, rule
names, ledgers and explorer, over the port's ``SharedPagePool``,
``PoolView``, ``PagePool``, ``KVArrayStore``, ``PrefixCache`` and
parking.  zenlint (``repro_torch.analysis.engine``) proves accounting
invariants *syntactically*, one function at a time.  The invariants
that actually protect tenants from each other, though, are cross-module
*runtime* properties of the arbitration state machine spanning
``SharedPagePool`` <-> ``PoolView`` <-> ``KVArrayStore`` <->
``PrefixCache`` <-> parking: conservation (every physical page is free,
view-granted, or cache-resident -- exactly one of the three), receipt
balance (park releases exactly what unpark restores), refcount sanity
(never negative, never stranded at eviction), and id-space isolation
(view-local ids never reach a decode table -- the runtime twin of
zenlint's ZL001).  Every hook reads host-side bookkeeping only: on the
card the sanitizer reads nothing from the device.

This module mirrors every mutation of that state machine into an
independent **shadow ledger** and re-derives the invariants after each
step.  The design mirrors ``repro_torch.obs.trace``:

* ``SAN`` is a module global, ``None`` by default.  Every instrumented
  site guards with ``s = zensan.SAN`` / ``if s is not None`` -- when
  disabled the entire plane costs one attribute load + one is-check per
  hook site, and attaches nothing to pool objects.
* ``REPRO_ZENSAN=1`` in the environment enables it at import time
  (strict mode: the first violation raises ``ZensanViolation``);
  ``REPRO_ZENSAN_REPORT=<path>`` additionally appends every violation
  to a report file (the CI artifact).  The variables are the
  reference's, so one setting sanitizes a run of both packages.

Shadow state lives ON the objects it mirrors (``pool._zs_ledger``,
``cache._zs_refs``, ``store._zs_local``) so its lifetime matches theirs
-- a global table keyed by ``id()`` would silently corrupt when ids are
reused after GC.  Ledgers snapshot lazily from the real structures on
first hook (and re-snapshot when ``enable()`` bumps the generation), so
the sanitizer can attach to a mid-flight pool and only validates
mutations it actually observed.

Page-state machine (per physical page of one root pool)::

    FREE --take--> STAGED --grant--> VIEW(app) --release--> STAGED
    STAGED --give--> FREE            VIEW --cache_donated--> CACHE(c)
    CACHE --give (cache free_fn on evict)--> FREE

``STAGED`` is the window between the shared pool popping pages and the
view remapping them (or the reverse); it is what lets both layers hook
independently without double-counting, and ``check()`` asserts it is
empty at every quiescent point (engine step end, park/unpark end).

``explore()`` is a bounded model checker over the same hooks: it
replays every depth-N interleaving of the arbitration ops
{grant, preempt, evict, park, unpark, prefix pin, donate} against a
small two-tenant model pool and checks the full ledger after every
single op.  ``docs/analysis.md`` holds the invariant catalogue.
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["SAN", "Sanitizer", "Violation", "ZensanViolation",
           "enable", "disable", "explore", "ExploreResult"]

#: page-state constants (owner-table values; FREE is absence)
_STAGED = ("staged",)

#: bumped by enable()/disable(): shadow state from an older generation
#: is stale (mutations happened unobserved) and is re-snapshotted
_GEN = 0


@dataclass
class Violation:
    """One invariant breach: the rule name (tests match on these), a
    human message, the offending *product* call site, and -- for
    conservation sweeps -- the ledger-vs-real diff."""

    rule: str
    message: str
    site: str
    diff: str = ""

    def render(self) -> str:
        out = f"zensan[{self.rule}] {self.message} @ {self.site}"
        if self.diff:
            out += f"\n  ledger diff: {self.diff}"
        return out


class ZensanViolation(AssertionError):
    """Raised in strict mode on the first ledger violation."""


def _site() -> str:
    """The innermost stack frame outside this module: the product code
    whose mutation (or whose quiescent point) tripped the invariant."""
    here = os.path.basename(__file__)
    for fr in reversed(traceback.extract_stack()):
        base = os.path.basename(fr.filename)
        if base != here:
            return f"{base}:{fr.lineno} in {fr.name}"
    return "<unknown>"


def _root(pool):
    """The object owning the physical page space: a PoolView's shared
    pool, else the (private) pool itself."""
    return getattr(pool, "shared", None) or pool


def _fmt(owner) -> str:
    if owner is None:
        return "FREE"
    if owner is _STAGED or owner == _STAGED:
        return "STAGED"
    kind, who = owner
    return f"{kind.upper()}({who!r})" if kind == "view" else f"CACHE(#{who})"


def _iter_caches(root):
    """Every prefix cache whose pages live in ``root``'s page space:
    the pod registry, a private pool's own cache, and any view-private
    cache (un-aliased tenant on a shared pool)."""
    seen = set()
    pcs = getattr(root, "prefix_caches", None)
    if pcs:
        for c in pcs.values():
            if id(c) not in seen:
                seen.add(id(c))
                yield c
    # NB: on SharedPagePool ``prefix_cache`` is the registry *accessor*
    # (a method); only a PagePool/PoolView carries a cache object there
    c = getattr(root, "prefix_cache", None)
    if c is not None and hasattr(c, "nodes") and id(c) not in seen:
        seen.add(id(c))
        yield c
    for v in getattr(root, "views", {}).values():
        c = getattr(v, "prefix_cache", None)
        if c is not None and hasattr(c, "nodes") and id(c) not in seen:
            seen.add(id(c))
            yield c


class Ledger:
    """Shadow owner table of ONE root pool's physical page space.

    ``owner`` maps page id -> ``("view", app)`` / ``("cache", cache-id)``
    / ``STAGED``; absence means FREE.  ``receipts`` holds outstanding
    park receipts keyed ``(app, req_id)`` -> ``(n_global, n_local)``.
    Snapshotted from the real structures at construction, maintained by
    the Sanitizer hooks afterwards."""

    __slots__ = ("gen", "total", "owner", "receipts")

    def __init__(self, root):
        self.gen = _GEN
        self.total = int(root.num_pages)
        self.owner: Dict[int, Tuple] = {}
        self.receipts: Dict[Tuple[str, str], Tuple[int, int]] = {}
        for cache in _iter_caches(root):
            for n in cache.nodes:
                self.owner[n.page] = ("cache", id(cache))
        views = getattr(root, "views", None)
        if views is not None:
            for app, v in views.items():
                for pid in v._remap.values():
                    self.owner[pid] = ("view", app)
        else:
            free = set(root.free)
            for pid in range(self.total):
                if pid not in free and pid not in self.owner:
                    self.owner[pid] = ("view", root.app)

    def free_set(self) -> set:
        return {p for p in range(self.total) if p not in self.owner}

    def owned_by(self, owner: Tuple) -> set:
        return {p for p, o in self.owner.items() if o == owner}


class _LocalSpace:
    """Shadow owner table of one local (sliding-window ring) page-id
    space.  The space's host is whoever owns the physical free list: a
    ``KVArrayStore`` (aliased tenants share it), a ``PoolView`` (private
    per-view space), or a private ``PagePool``.  ``flist`` anchors the
    exact list object -- ``set_groups`` replacing it redefines the id
    space, which invalidates this snapshot."""

    __slots__ = ("gen", "flist", "owner")

    def __init__(self, host, flist, root):
        self.gen = _GEN
        self.flist = flist
        self.owner: Dict[int, str] = {}
        if hasattr(host, "users"):                 # KVArrayStore
            for v in getattr(root, "views", {}).values():
                if getattr(v, "kv_store", None) is host:
                    for p in v._remap_local.values():
                        self.owner[p] = v.app
        elif hasattr(host, "_remap_local"):        # PoolView private space
            for p in host._remap_local.values():
                self.owner[p] = host.app
        else:                                      # private PagePool
            free = set(flist)
            for p in range(host._local_space()):
                if p not in free:
                    self.owner[p] = host.app


def _local_host(pool):
    st = getattr(pool, "kv_store", None)
    if st is not None and getattr(st, "free_local", None) is not None:
        return st
    return pool


class Sanitizer:
    """The hook sink.  Instrumented sites call one method per mutation;
    ``check()`` re-derives every invariant against the real structures.
    ``strict`` raises on the first violation (the CI/test mode);
    non-strict accumulates (the explorer mode, which wants the full
    violation set across an interleaving sweep)."""

    def __init__(self, strict: bool = True,
                 report_path: Optional[str] = None):
        self.strict = strict
        self.report_path = report_path
        self.violations: List[Violation] = []
        self.events = 0          # hook invocations observed (bench/meta)

    # -- plumbing ------------------------------------------------------------
    def _viol(self, rule: str, message: str, diff: str = "") -> None:
        v = Violation(rule, message, _site(), diff)
        self.violations.append(v)
        if self.report_path:
            try:
                d = os.path.dirname(self.report_path)
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(self.report_path, "a") as f:
                    f.write(v.render() + "\n")
            except OSError:
                pass
        if self.strict:
            raise ZensanViolation(v.render())

    def _ledger(self, root) -> Tuple[Ledger, bool]:
        """-> (ledger, freshly-snapshotted).  A fresh snapshot reads the
        REAL structures, which mid-operation already reflect the mutation
        the triggering hook describes -- that hook must then coerce the
        state its composite's later hooks expect WITHOUT running its
        checks (there is no before-state to check against)."""
        led = getattr(root, "_zs_ledger", None)
        if led is None or led.gen != _GEN:
            led = Ledger(root)
            root._zs_ledger = led
            return led, True
        return led, False

    def _space(self, pool, root) -> Tuple[Optional[_LocalSpace], bool]:
        host = _local_host(pool)
        flist = getattr(host, "free_local", None)
        if flist is None:
            return None, False
        sp = getattr(host, "_zs_local", None)
        if sp is None or sp.gen != _GEN or sp.flist is not flist:
            sp = _LocalSpace(host, flist, root)
            host._zs_local = sp
            return sp, True
        return sp, False

    def _refs(self, cache) -> Tuple[Dict[int, int], bool]:
        """-> (shadow refcounts, freshly-snapshotted).  A fresh snapshot
        reads the REAL post-mutation refs, so the hook that triggered it
        must not re-apply its delta on top."""
        refs = getattr(cache, "_zs_refs", None)
        if refs is None or getattr(cache, "_zs_gen", None) != _GEN:
            refs = {id(n): n.refs for n in cache.nodes}
            cache._zs_refs = refs
            cache._zs_gen = _GEN
            return refs, True
        return refs, False

    # -- global page-space hooks ---------------------------------------------
    def take(self, pool, pages: List[int]) -> None:
        """Pages popped off the root free list (FREE -> STAGED)."""
        self.events += 1
        led, fresh = self._ledger(_root(pool))
        for p in pages:
            if not fresh:
                cur = led.owner.get(p)
                if cur is not None:
                    self._viol("double-grant",
                               f"page {p} popped from the free list while "
                               f"the ledger holds it as {_fmt(cur)}")
            led.owner[p] = _STAGED

    def give(self, pool, pages: List[int]) -> None:
        """Pages pushed back on the root free list (STAGED/CACHE ->
        FREE).  A page already free is a double-free; a page still
        granted to a view is freed out from under its owner."""
        self.events += 1
        led, fresh = self._ledger(_root(pool))
        if fresh:
            # hook fires just before the real free-list extend: FREE is
            # where these pages are headed, and absence IS free
            for p in pages:
                led.owner.pop(p, None)
            return
        for p in pages:
            cur = led.owner.get(p)
            if cur is None:
                self._viol("double-free",
                           f"page {p} returned to the free list twice")
            elif cur[0] == "view":
                self._viol("foreign-free",
                           f"page {p} freed while still granted to view "
                           f"{cur[1]!r} (no release observed)")
            else:
                del led.owner[p]

    def grant(self, pool, vids: List[int], phys: List[int]) -> None:
        """Physical pages bound to a view's remap (STAGED -> VIEW) --
        the one point where quota <= cap is enforceable."""
        self.events += 1
        app = getattr(pool, "app", "?")
        led, fresh = self._ledger(_root(pool))
        for p in phys:
            if not fresh:
                cur = led.owner.get(p)
                if cur != _STAGED:
                    self._viol("double-grant",
                               f"page {p} granted to view {app!r} while "
                               f"the ledger holds it as {_fmt(cur)}")
            led.owner[p] = ("view", app)
        quota = getattr(pool, "quota", None)
        used = getattr(pool, "used", None)
        if quota is not None and used is not None and used > quota:
            self._viol("quota-overdraft",
                       f"view {app!r} holds used={used} > quota={quota} "
                       f"after a grant of {len(phys)} page(s)")

    def release(self, pool, vids: List[int], phys: List[int]) -> None:
        """View remap entries dropped (VIEW -> STAGED); ``give``
        completes the round trip."""
        self.events += 1
        app = getattr(pool, "app", "?")
        led, fresh = self._ledger(_root(pool))
        for p in phys:
            if not fresh:
                cur = led.owner.get(p)
                if cur != ("view", app):
                    self._viol("foreign-free",
                               f"view {app!r} released page {p} the "
                               f"ledger holds as {_fmt(cur)}")
            led.owner[p] = _STAGED

    def cache_donated(self, pool, phys: List[int], cache) -> None:
        """Pages moved out of a view's accounting into prefix-cache
        ownership (VIEW -> CACHE): off the quota, NOT on the free list."""
        self.events += 1
        app = getattr(pool, "app", "?")
        led, fresh = self._ledger(_root(pool))
        ckey = id(cache) if cache is not None else 0
        for p in phys:
            if not fresh:
                cur = led.owner.get(p)
                if cur != ("view", app):
                    self._viol("foreign-free",
                               f"view {app!r} donated page {p} the ledger "
                               f"holds as {_fmt(cur)}")
            led.owner[p] = ("cache", ckey)

    # -- local (ring) page-space hooks ---------------------------------------
    def grant_local(self, pool, phys: List[int]) -> None:
        self.events += 1
        app = getattr(pool, "app", "?")
        sp, fresh = self._space(pool, _root(pool))
        if sp is None:
            return
        for p in phys:
            if not fresh:
                cur = sp.owner.get(p)
                if cur is not None:
                    self._viol("double-grant",
                               f"local page {p} granted to {app!r} while "
                               f"owned by {cur!r}")
            sp.owner[p] = app
        quota = getattr(pool, "quota", None)
        used = getattr(pool, "used_local", None)
        if quota is not None and used is not None and used > quota:
            self._viol("quota-overdraft",
                       f"view {app!r} holds used_local={used} > "
                       f"quota={quota} after a local grant of {len(phys)}")

    def release_local(self, pool, phys: List[int]) -> None:
        self.events += 1
        app = getattr(pool, "app", "?")
        sp, fresh = self._space(pool, _root(pool))
        if sp is None:
            return
        for p in phys:
            cur = sp.owner.pop(p, None)
            if fresh:
                continue          # no before-state to hold anyone to
            if cur is None:
                self._viol("double-free",
                           f"local page {p} returned to the free list "
                           "twice")
            elif cur != app:
                self._viol("foreign-free",
                           f"view {app!r} released local page {p} owned "
                           f"by {cur!r}")

    # -- prefix-cache refcount hooks -----------------------------------------
    def pinned(self, cache, nodes) -> None:
        self.events += 1
        refs, fresh = self._refs(cache)
        if fresh:
            return                # snapshot already holds the new pins
        for n in nodes:
            if id(n) in refs:
                refs[id(n)] += 1
            else:                 # un-hooked creation: adopt post-state
                refs[id(n)] = n.refs

    def unpinned(self, cache, nodes) -> None:
        self.events += 1
        refs, fresh = self._refs(cache)
        if fresh:
            return
        for n in nodes:
            if id(n) not in refs:
                refs[id(n)] = n.refs
                continue
            refs[id(n)] -= 1
            if refs[id(n)] < 0:
                self._viol("refcount-negative",
                           f"cache {cache.key!r}: unpin drove node page "
                           f"{n.page} below zero pins")
                refs[id(n)] = n.refs
    def inserted(self, cache, created) -> None:
        """Freshly adopted nodes come back pinned for the donor."""
        self.events += 1
        refs, fresh = self._refs(cache)
        if fresh:
            return
        for n in created:
            if id(n) in refs:
                refs[id(n)] += 1
            else:
                refs[id(n)] = n.refs

    def evicted(self, cache, node) -> None:
        """A node leaving the trie must carry zero pins; its page goes
        back through the cache's free_fn (CACHE -> FREE via ``give``)."""
        self.events += 1
        refs, _ = self._refs(cache)
        sh = refs.pop(id(node), node.refs)
        if sh != 0 or node.refs != 0:
            self._viol("refcount-stranded",
                       f"cache {cache.key!r}: evicted node page "
                       f"{node.page} with shadow refs={sh} "
                       f"(real {node.refs}) -- pinned pages must never "
                       "be evicted")

    # -- park / unpark receipts ----------------------------------------------
    def parked(self, pool, req_id: str, n: int, n_local: int) -> None:
        """reclaim(): the receipt unpark must balance, page-for-page."""
        self.events += 1
        app = getattr(pool, "app", "?")
        led, _ = self._ledger(_root(pool))
        led.receipts[(app, req_id)] = (n, n_local)

    def regranted(self, pool, req_id: str, n: int, n_local: int) -> None:
        self.events += 1
        app = getattr(pool, "app", "?")
        led, _ = self._ledger(_root(pool))
        rec = led.receipts.pop((app, req_id), None)
        if rec is not None and rec != (n, n_local):
            self._viol("park-mismatch",
                       f"request {req_id!r} ({app!r}) parked "
                       f"{rec[0]}+{rec[1]} pages but was regranted "
                       f"{n}+{n_local}")

    def park_cancel(self, pool, req_id: str) -> None:
        """The request falls back to the at-least-once requeue path (no
        regrant will come): the receipt is resolved, not stranded."""
        self.events += 1
        app = getattr(pool, "app", "?")
        self._ledger(_root(pool))[0].receipts.pop((app, req_id), None)

    def unpark_done(self, pool, app: str) -> None:
        """End of unpark: every one of the app's park receipts must have
        been regranted or explicitly cancelled."""
        self.events += 1
        led, _ = self._ledger(_root(pool))
        stale = [k for k in led.receipts if k[0] == app]
        for key in stale:
            n, n_local = led.receipts.pop(key)
            self._viol("stranded-park-receipt",
                       f"request {key[1]!r} ({app!r}) parked "
                       f"{n}+{n_local} pages but unpark neither "
                       "regranted nor requeued it")

    # -- runtime id-escape (decode tables; zenlint ZL001's twin) -------------
    def table(self, pool, g_rows, l_rows) -> None:
        """Every physical id entering a decode page table must be a page
        this view owns or a (read-only) cache page -- anything else is a
        view-local id that escaped translation, or another tenant's
        page."""
        self.events += 1
        if pool is None:
            return
        app = getattr(pool, "app", "?")
        led, _ = self._ledger(_root(pool))
        for row in g_rows:
            for p in row:
                o = led.owner.get(p)
                if o is None or (o[0] == "view" and o[1] != app) \
                        or o is _STAGED or o == _STAGED:
                    self._viol("id-escape",
                               f"decode table for {app!r} references "
                               f"physical page {p} held as {_fmt(o)}")
        sp, _ = self._space(pool, _root(pool))
        if sp is None:
            return
        for row in l_rows:
            for p in row:
                if sp.owner.get(p) != app:
                    self._viol("id-escape",
                               f"decode ring table for {app!r} references "
                               f"local page {p} held by "
                               f"{sp.owner.get(p)!r}")

    # -- dense backend slot table --------------------------------------------
    def dense_state(self, runner, running) -> None:
        """DenseRunner bookkeeping: every running request has a slot and
        a token tail, and no two share a slot."""
        self.events += 1
        seen: Dict[int, str] = {}
        for r in running:
            ent = runner.slots.get(r.req_id)
            if ent is None:
                self._viol("dense-slot",
                           f"running request {r.req_id!r} has no dense "
                           "slot")
                continue
            slot = ent[0] if isinstance(ent, tuple) else ent
            if slot in seen:
                self._viol("dense-slot",
                           f"slot {slot} assigned to both {seen[slot]!r} "
                           f"and {r.req_id!r}")
            seen[slot] = r.req_id
            if r.req_id not in runner.generated:
                self._viol("dense-slot",
                           f"running request {r.req_id!r} has no "
                           "generated-token tail")

    # -- teardown ------------------------------------------------------------
    def view_closed(self, view) -> None:
        """A view detaching from the pod must hold nothing; its park
        receipts (an app released while parked) are torn down with it."""
        self.events += 1
        app = getattr(view, "app", "?")
        led, _ = self._ledger(_root(view))
        owned = led.owned_by(("view", app))
        if owned:
            self._viol("view-leak",
                       f"view {app!r} closed while still holding "
                       f"{len(owned)} page(s): {sorted(owned)}")
            for p in owned:
                del led.owner[p]
        for key in [k for k in led.receipts if k[0] == app]:
            del led.receipts[key]

    # -- the full sweep ------------------------------------------------------
    def check(self, pool) -> None:
        """Re-derive every invariant at a quiescent point (engine step
        end, park/unpark end, after each explorer op): the ledger and
        the real structures must tell the same story."""
        self.events += 1
        root = _root(pool)
        led, _ = self._ledger(root)
        diffs: List[str] = []

        real_free = list(root.free)
        if len(set(real_free)) != len(real_free):
            dup = sorted(p for p in set(real_free)
                         if real_free.count(p) > 1)
            diffs.append(f"free list holds duplicates: {dup}")
        led_free = led.free_set()
        if set(real_free) != led_free:
            missing = sorted(led_free - set(real_free))
            extra = sorted(set(real_free) - led_free)
            diffs.append(f"free-list mismatch: ledger-free-but-real-held "
                         f"{missing}, real-free-but-ledger-held {extra}")
        staged = sorted(led.owned_by(_STAGED))
        if staged:
            diffs.append(f"pages stuck in STAGED at a quiescent point: "
                         f"{staged}")

        views = getattr(root, "views", None)
        if views is not None:
            for app, v in views.items():
                owned = led.owned_by(("view", app))
                remap = set(v._remap.values())
                if remap != owned:
                    diffs.append(
                        f"view {app!r}: remap pages {sorted(remap)} != "
                        f"ledger grant {sorted(owned)}")
                if v.used != len(v._remap):
                    diffs.append(f"view {app!r}: used={v.used} != "
                                 f"|remap|={len(v._remap)}")

        for cache in _iter_caches(root):
            refs, _ = self._refs(cache)
            live = set()
            pages = set()
            for n in cache.nodes:
                live.add(id(n))
                pages.add(n.page)
                sh = refs.get(id(n))
                if sh is None:
                    refs[id(n)] = n.refs
                elif sh != n.refs:
                    self._viol(
                        "refcount-leak",
                        f"cache {cache.key!r}: node page {n.page} has "
                        f"real refs={n.refs} but shadow refs={sh} -- a "
                        "pin/unpin bypassed the hooks or leaked")
                    refs[id(n)] = n.refs
            for k in [k for k in refs if k not in live]:
                del refs[k]
            owned = led.owned_by(("cache", id(cache)))
            if pages != owned:
                diffs.append(
                    f"cache {cache.key!r}: trie pages {sorted(pages)} != "
                    f"ledger cache-owned {sorted(owned)}")

        if views is not None:
            for key, st in root.kv_stores.items():
                for u in st.users:
                    v = views.get(u)
                    if v is None:
                        self._viol("store-users",
                                   f"KV store {key!r} lists user {u!r} "
                                   "but the pod has no such view")
                    elif getattr(v, "kv_store", None) is not st:
                        self._viol("store-users",
                                   f"KV store {key!r} lists user {u!r} "
                                   "whose view aliases a different store")
            for v in views.values():
                st = getattr(v, "kv_store", None)
                if st is not None and v.app not in st.users:
                    self._viol("store-users",
                               f"view {v.app!r} aliases store "
                               f"{st.key!r} but is missing from "
                               "store.users")

        self._check_local(root, views, diffs)

        if diffs:
            self._viol("conservation",
                       f"ledger/reality divergence on pool of "
                       f"{led.total} pages", diff="; ".join(diffs))

    def _check_local(self, root, views, diffs: List[str]) -> None:
        hosts = []
        if views is not None:
            for st in root.kv_stores.values():
                if getattr(st, "free_local", None) is not None:
                    hosts.append((st, [v for v in views.values()
                                       if getattr(v, "kv_store", None)
                                       is st]))
            for v in views.values():
                if (v.free_local is not None
                        and _local_host(v) is v):
                    hosts.append((v, [v]))
        elif getattr(root, "free_local", None) is not None:
            hosts.append((root, []))
        for host, vs in hosts:
            flist = host.free_local
            sp = getattr(host, "_zs_local", None)
            if sp is None or sp.gen != _GEN or sp.flist is not flist:
                continue          # never hooked this space: nothing owed
            if len(set(flist)) != len(flist):
                diffs.append("local free list holds duplicates")
            overlap = set(flist) & set(sp.owner)
            if overlap:
                diffs.append(f"local pages both free and granted: "
                             f"{sorted(overlap)}")
            for v in vs:
                mine = {p for p, a in sp.owner.items() if a == v.app}
                remap = set(v._remap_local.values())
                if remap != mine:
                    diffs.append(
                        f"view {v.app!r}: local remap {sorted(remap)} != "
                        f"ledger {sorted(mine)}")
                if v.used_local != len(v._remap_local):
                    diffs.append(
                        f"view {v.app!r}: used_local={v.used_local} != "
                        f"|remap_local|={len(v._remap_local)}")


#: THE sanitizer.  None (the default) means every hook site is a single
#: attribute load + is-check; enable() swaps in a live instance.
SAN: Optional[Sanitizer] = None


def enable(strict: bool = True,
           report_path: Optional[str] = None) -> Sanitizer:
    """Install a fresh sanitizer.  Bumps the shadow generation so every
    ledger re-snapshots from the real structures on next contact --
    mutations made while disabled were unobserved and must not count."""
    global SAN, _GEN
    _GEN += 1
    SAN = Sanitizer(strict=strict, report_path=report_path)
    return SAN


def disable() -> None:
    global SAN, _GEN
    _GEN += 1
    SAN = None


def _install(san: Optional[Sanitizer]) -> None:
    """Restore a previous sanitizer (the explorer's save/restore)."""
    global SAN, _GEN
    _GEN += 1
    SAN = san


# -- bounded schedule explorer ----------------------------------------------

#: the arbitration op alphabet: every depth-N product over these is one
#: schedule.  Two tenants ("a": two-page prompts, "b": one-page prompts
#: sharing a's leading page) over one 12-page pod pool + one shared
#: prefix cache covers grant/preempt/evict/park/unpark/pin/donate
#: interleavings including cross-tenant prefix reuse and COW pins.
EXPLORE_OPS = ("grant_a", "grant_b", "preempt_a", "park_a",
               "unpark_a", "evict", "pin_b", "donate_a")


@dataclass
class ExploreResult:
    depth: int
    sequences: int
    ops_applied: int
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def _model_state(pool_pages: int):
    from repro_torch.serving.kv_cache import PAGE_SIZE
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.tenancy import SharedPagePool

    shared = SharedPagePool(pool_pages)
    cache = shared.prefix_cache(
        ("zensan-model",),
        lambda: PrefixCache(("zensan-model",), shared._give))
    views = {}
    for app in ("a", "b"):
        v = shared.view(app, quota="fair", policy="fixed",
                        fixed_init_pages=1, fixed_step_pages=1)
        v.prefix_cache = cache
        cache.users.add(app)
        views[app] = v
    return {
        "shared": shared, "cache": cache, "views": views,
        "prompts": {"a": tuple(range(2 * PAGE_SIZE)),
                    "b": tuple(range(PAGE_SIZE))},
        "running": {"a": [], "b": []},
        "parked": {"a": [], "b": []},
        "pins": [], "n": 0, "unpins": 0,
    }


def _op_grant(st, app) -> None:
    v = st["views"][app]
    if v.parked:
        return
    st["n"] += 1
    toks = st["prompts"][app]
    from repro_torch.serving.kv_cache import Request
    r = Request(f"{app}{st['n']}", len(toks),
                max_new_tokens=8, prompt_tokens=toks)
    m = st["cache"].pin(toks, max_len=len(toks) - 1)
    r.prefix_nodes = m.nodes
    r.shared_pages = list(m.phys_pages)
    r.cached_len = m.cached_len
    r.cow_src_page = m.cow_src
    if v.try_admit(r):
        st["running"][app].append(r)
    else:
        v.prefix_detach(r)


def _op_preempt(st, app) -> None:
    run = st["running"][app]
    if run:
        st["views"][app].release(run.pop())


def _op_park(st, app) -> None:
    v = st["views"][app]
    if v.parked:
        return
    st["parked"][app] = [(r, v.reclaim(r)) for r in st["running"][app]]
    st["running"][app] = []
    v.parked = True


def _op_unpark(st, app) -> None:
    """The explorer plays the parking controller: re-pin, regrant --
    and resolve (cancel) the receipt of any request that falls back to
    the recompute path, exactly as autoscale.parking does."""
    v = st["views"][app]
    if not v.parked:
        return
    v.parked = False
    s = SAN
    cache = st["cache"]
    for r, (g, l) in st["parked"][app]:
        if r.parked_shared:
            m = cache.pin(r.prompt_tokens, max_full=r.parked_shared)
            if len(m.phys_pages) < r.parked_shared:
                # evicted while parked: recompute from scratch
                st["unpins"] += cache.unpin(m.nodes)
                r.prefix_nodes, r.shared_pages = None, []
                r.cached_len, r.cow_src_page, r.parked_shared = 0, None, 0
                if s is not None:
                    s.park_cancel(v, r.req_id)
                continue
            r.prefix_nodes = m.nodes
            r.shared_pages = list(m.phys_pages)
            r.parked_shared = 0
        if v.regrant(r, len(g), len(l)):
            st["running"][app].append(r)
        else:
            v.prefix_detach(r)
            if s is not None:
                s.park_cancel(v, r.req_id)
    st["parked"][app] = []
    if s is not None:
        s.unpark_done(v, app)


def _op_evict(st) -> None:
    st["shared"]._evict_prefix(1)


def _op_pin(st, app) -> None:
    pins = st["pins"]
    if pins:
        st["unpins"] += st["cache"].unpin(pins.pop().nodes)
        return
    m = st["cache"].pin(st["prompts"]["a"])
    if m.nodes:
        pins.append(m)


def _op_donate(st, app) -> None:
    """Mirror PagedRunner._prefix_insert's full-page accounting: move
    freshly 'prefilled' prompt pages from the donor's quota into the
    shared cache, pinned for the donor."""
    from repro_torch.serving.kv_cache import PAGE_SIZE
    v = st["views"][app]
    cache = st["cache"]
    for r in st["running"][app]:
        n_full = r.prompt_len // PAGE_SIZE
        n_att = len(r.shared_pages)
        if n_att >= n_full:
            continue
        n_new, _ = cache.probe_new(r.prompt_tokens, n_att)
        if n_new == 0 or len(r.pages) < n_new:
            continue
        phys = v.cache_donate(r.pages[:n_new])
        del r.pages[:n_new]
        r.shared_pages.extend(phys)
        created = cache.insert(r.prompt_tokens[:n_full * PAGE_SIZE],
                               n_att, phys)
        r.prefix_nodes = (r.prefix_nodes or []) + created
        return


def _apply(st, op: str) -> None:
    kind, _, app = op.partition("_")
    if kind == "grant":
        _op_grant(st, app)
    elif kind == "preempt":
        _op_preempt(st, app)
    elif kind == "park":
        _op_park(st, app)
    elif kind == "unpark":
        _op_unpark(st, app)
    elif kind == "evict":
        _op_evict(st)
    elif kind == "pin":
        _op_pin(st, app)
    elif kind == "donate":
        _op_donate(st, app)
    else:
        raise ValueError(f"unknown explore op {op!r}")


def explore(depth: int = 3, ops=EXPLORE_OPS,
            pool_pages: int = 12) -> ExploreResult:
    """Replay EVERY ``len(ops) ** depth`` interleaving of the
    arbitration ops against a fresh two-tenant model pool, running the
    full ledger check after every single op.  A bounded model checker:
    any reachable accounting bug within ``depth`` steps of a clean pool
    surfaces as a named violation with its schedule's call site.

    Installs its own non-strict sanitizer for the sweep (so one bad
    schedule doesn't hide the rest) and restores the previous one."""
    import itertools

    prev = SAN
    san = enable(strict=False)
    applied = sequences = 0
    try:
        for seq in itertools.product(ops, repeat=depth):
            st = _model_state(pool_pages)
            sequences += 1
            for op in seq:
                _apply(st, op)
                applied += 1
                san.check(st["views"]["a"])
    finally:
        _install(prev)
    return ExploreResult(depth=depth, sequences=sequences,
                         ops_applied=applied,
                         violations=list(san.violations))


# -- env gate (mirrors repro_torch.obs: the ONLY activation cost when unset is
#    this import-time check) -------------------------------------------------
if os.environ.get("REPRO_ZENSAN", "") not in ("", "0"):
    enable(strict=True,
           report_path=os.environ.get("REPRO_ZENSAN_REPORT") or None)
