"""Global prefix cache: refcounted copy-on-write KV pages on the paged
data plane.  A copy of ``repro/serving/prefix_cache.py``, with its runtime
sanitizer's hooks (``repro_torch.analysis.zensan``).

At high-overlap serving load most prompts share a long common prefix (a
system prompt, a few-shot template), so the dominant prefill cost is
recomputing KV every co-tenant has already computed.  This module is the
index that removes that waste: a radix/trie keyed on token-id prefixes at
**page granularity** whose nodes own **refcounted, read-only physical
pages** in the pod's shared pool.  Prefill then computes only the
un-cached suffix (see ``PagedRunner``'s chunked prefill) and appends the
suffix KV into freshly granted private pages.

Node classes:

* **full** nodes hold exactly ``PAGE_SIZE`` tokens and may have children
  -- the radix edges.  A request whose prompt matches a chain of full
  nodes references those *physical* pages directly in its decode page
  table (``Request.shared_pages``), never writing them.
* **partial** leaves hold the tail of some earlier prompt (< PAGE_SIZE
  tokens).  A later prompt that agrees with the leaf on a non-empty lead
  and then diverges -- or extends past it -- triggers **copy-on-write**:
  the page is copied into the requester's private grant (the matched
  ``lead`` slots) and the divergent suffix is written there.  Divergence
  exactly at a page boundary is a plain miss, no copy.

Lifecycle:
``pin`` (lookup; refs++ along the matched chain) -> suffix prefill ->
``insert`` (donate the prompt's full pages; created nodes are pinned for
the donor) -> ``unpin`` on release/park -> refcount-0 LRU eviction under
pool pressure (``SharedPagePool._take`` shortfall).  Pinned nodes are
never evicted -- a mid-decode request's prefix pages cannot be pulled
out from under it.

Ownership: cached pages belong to the CACHE, not to any request or
``PoolView`` -- they are excluded from per-view quota charging (the view
"donates" them via ``cache_donate``) but stay out of the pool's free
list, so pod-level ``used_pages``/utilization still reports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.analysis import zensan
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.kv_cache import PAGE_SIZE


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    """Longest-common-prefix length of two token sequences."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixNode:
    """One cached page: ``tokens`` (the page's token ids), the physical
    ``page`` holding their KV, a refcount (pins by in-flight requests),
    and an LRU stamp.  Full nodes are radix edges; partial nodes are
    leaves (COW sources)."""

    __slots__ = ("tokens", "page", "full", "children", "partials",
                 "parent", "refs", "last_used")

    def __init__(self, tokens: Tuple[int, ...], page: int, full: bool,
                 parent: Optional["PrefixNode"]):
        self.tokens = tokens
        self.page = page
        self.full = full
        self.children = {}           # full-page token tuple -> PrefixNode
        self.partials: List["PrefixNode"] = []
        self.parent = parent
        self.refs = 0
        self.last_used = 0


@dataclass
class PrefixMatch:
    """One pinned lookup result.  ``phys_pages`` are the fully-matched
    chain's PHYSICAL page ids, table-ready (requests store them on
    ``shared_pages``, never translated through a view remap).
    ``cow_src`` is the physical page a partial/diverged match must be
    copied from before the requester writes past ``cached_len``."""

    phys_pages: List[int] = field(default_factory=list)
    cached_len: int = 0
    cow_src: Optional[int] = None
    nodes: List[PrefixNode] = field(default_factory=list)

    @property
    def hit(self) -> bool:
        return self.cached_len > 0


class PrefixCache:
    """Radix index over page-granular token prefixes -> refcounted
    read-only physical pages.

    ``free_fn`` returns evicted pages to whatever free list granted them
    (``SharedPagePool._give`` for pod-shared tenancy, the private pool's
    free list otherwise).  One cache is keyed per (KV shape, model,
    seed): KV content is a function of tokens AND params, so tenants may
    share a cache only when they share both the device arrays and the
    weights."""

    def __init__(self, key: Tuple, free_fn: Callable[[List[int]], None]):
        self.key = key
        self.free_fn = free_fn
        self.root = PrefixNode((), -1, True, None)
        self.nodes: List[PrefixNode] = []
        self._clock = 0
        self.users: set = set()      # app names bound to this cache
        self.stats = {"lookups": 0, "hits": 0, "hit_pages": 0,
                      "hit_tokens": 0, "inserted_pages": 0,
                      "evicted_pages": 0, "cow_copies": 0, "unpinned": 0}

    # -- accounting ----------------------------------------------------------
    @property
    def num_pages(self) -> int:
        """Physical pages the cache currently owns."""
        return len(self.nodes)

    @property
    def hit_rate(self) -> float:
        return self.stats["hits"] / max(self.stats["lookups"], 1)

    def _touch(self, node: PrefixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- lookup / pin --------------------------------------------------------
    def pin(self, tokens: Sequence[int], *, max_len: Optional[int] = None,
            max_full: Optional[int] = None) -> PrefixMatch:
        """Match ``tokens`` against the trie and PIN the matched chain
        (refs++ on every node, so eviction cannot take the pages while
        the requester decodes through them).  The receipt is the match:
        callers must keep it and later ``unpin(match.nodes)``.

        ``max_len`` caps the usable cached length (prefill passes
        ``prompt_len - 1``: at least one position must be computed to
        produce the first-token logits).  ``max_full`` restricts the
        match to full-page nodes only (parking's re-attach path, which
        must reproduce an exact earlier page-chain boundary)."""
        toks = tuple(tokens)
        if max_len is not None:
            toks = toks[:max_len]
        self.stats["lookups"] += 1
        chain: List[PrefixNode] = []
        node = self.root
        i = 0
        while ((i + 1) * PAGE_SIZE <= len(toks)
               and (max_full is None or i < max_full)):
            child = node.children.get(toks[i * PAGE_SIZE:(i + 1) * PAGE_SIZE])
            if child is None:
                break
            chain.append(child)
            node = child
            i += 1
        full_pages = [n.page for n in chain]
        cached_len = i * PAGE_SIZE
        cow_src = None
        if max_full is None:
            rem = toks[i * PAGE_SIZE:]
            if rem:
                best, best_l = None, 0
                for cand in list(node.children.values()) + node.partials:
                    l = _lcp(cand.tokens, rem)
                    if l > best_l:
                        best, best_l = cand, l
                if best is not None:
                    # divergence (or extension) INSIDE a page: the lead
                    # slots are reusable via copy-on-write; divergence
                    # exactly at the page boundary lands here with
                    # best_l == 0 and stays a plain miss
                    chain.append(best)
                    cow_src = best.page
                    cached_len += best_l
        for n in chain:
            n.refs += 1
            self._touch(n)
        s = zensan.SAN
        if s is not None:
            s.pinned(self, chain)
        if cached_len > 0:
            self.stats["hits"] += 1
            self.stats["hit_pages"] += len(full_pages)
            self.stats["hit_tokens"] += cached_len
        t = obs_trace.TRACER
        if t is not None:
            # the cache's own view of the lookup (the request-scoped
            # prefix_pin instant is the attach-side receipt)
            t.instant("pool", "prefix_lookup", None,
                      {"hit": cached_len > 0, "cached_len": cached_len,
                       "full_pages": len(full_pages),
                       "cow": cow_src is not None})
        return PrefixMatch(phys_pages=full_pages, cached_len=cached_len,
                           cow_src=cow_src, nodes=chain)

    def unpin(self, nodes: Sequence[PrefixNode]) -> int:
        """Drop one pin from each node; returns how many nodes became
        evictable (refs hit 0) -- the receipt callers fold into their
        accounting."""
        released = 0
        for n in nodes:
            n.refs -= 1
            if n.refs < 0:
                raise RuntimeError("prefix-cache pin/unpin imbalance")
            self._touch(n)
            if n.refs == 0:
                released += 1
        s = zensan.SAN
        if s is not None:
            s.unpinned(self, nodes)
        self.stats["unpinned"] += released
        return released

    # -- insert --------------------------------------------------------------
    def probe_new(self, tokens: Sequence[int],
                  from_page: int) -> Tuple[int, bool]:
        """How much of ``tokens`` insert() would ADOPT, starting at full
        page ``from_page`` (the depth the donor matched at pin time):
        ``(n_new_full_pages, partial_is_new)``.  Returns (0, False) when
        a racing tenant already cached past ``from_page`` -- donated
        pages must extend the donor's own shared prefix contiguously, so
        a raced insert adopts nothing and the donor simply keeps its
        private copies."""
        toks = tuple(tokens)
        n_full = len(toks) // PAGE_SIZE
        node = self.root
        depth = 0
        while depth < n_full:
            child = node.children.get(
                toks[depth * PAGE_SIZE:(depth + 1) * PAGE_SIZE])
            if child is None:
                break
            node = child
            depth += 1
        if depth != from_page:
            return 0, False
        rem = toks[n_full * PAGE_SIZE:]
        partial_new = bool(rem) and not any(
            _lcp(c.tokens, rem) == len(rem)
            for c in list(node.children.values()) + node.partials)
        return n_full - depth, partial_new

    def insert(self, tokens: Sequence[int], from_page: int,
               phys_pages: Sequence[int],
               partial_page: Optional[int] = None) -> List[PrefixNode]:
        """Adopt donated pages into the trie: one full node per entry of
        ``phys_pages`` (full pages ``from_page``..), plus one partial
        leaf for the prompt tail when ``partial_page`` is given.  The
        caller sized the donation with :meth:`probe_new` in the same
        engine tick, so creation cannot race past it.  Created nodes
        come back PINNED for the donor (it still decodes through those
        pages); the partial leaf is pinned too and released with the
        rest at ``unpin`` time."""
        toks = tuple(tokens)
        node = self.root
        for j in range(from_page):
            node = node.children[toks[j * PAGE_SIZE:(j + 1) * PAGE_SIZE]]
        created: List[PrefixNode] = []
        for off, page in enumerate(phys_pages):
            j = from_page + off
            key = toks[j * PAGE_SIZE:(j + 1) * PAGE_SIZE]
            if len(key) != PAGE_SIZE or key in node.children:
                raise RuntimeError("insert() past probe_new(): donation "
                                   "raced")
            child = PrefixNode(key, int(page), True, node)
            node.children[key] = child
            self.nodes.append(child)
            created.append(child)
            node = child
        if partial_page is not None:
            rem = toks[(from_page + len(phys_pages)) * PAGE_SIZE:]
            if not 0 < len(rem) < PAGE_SIZE:
                raise ValueError("partial insert needs a tail")
            leaf = PrefixNode(rem, int(partial_page), False, node)
            node.partials.append(leaf)
            self.nodes.append(leaf)
            created.append(leaf)
        for n in created:
            n.refs += 1
            self._touch(n)
        s = zensan.SAN
        if s is not None:
            s.inserted(self, created)
        self.stats["inserted_pages"] += len(created)
        return created

    # -- eviction (refcount-0 LRU under pool pressure) -----------------------
    def peek_evictable(self) -> Optional[PrefixNode]:
        """The least-recently-used node with no pins and no dependants
        (leaf-first: evicting an interior node would orphan its
        subtree), or None.  Pinned nodes are NEVER candidates."""
        best = None
        for n in self.nodes:
            if n.refs or n.children or n.partials:
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        return best

    def evict(self, node: PrefixNode) -> List[int]:
        """Remove one evictable node, returning its page to the pool via
        ``free_fn``.  Returns the freed physical page ids."""
        if node.refs or node.children or node.partials:
            raise RuntimeError("evict() of a pinned or interior node")
        parent = node.parent
        if node.full:
            parent.children.pop(node.tokens, None)
        else:
            parent.partials.remove(node)
        self.nodes.remove(node)
        s = zensan.SAN
        if s is not None:
            s.evicted(self, node)
        freed = [node.page]
        self.free_fn(freed)
        self.stats["evicted_pages"] += len(freed)
        return freed

    def evict_lru(self, need: int) -> int:
        """Evict refcount-0 nodes LRU-first until ``need`` pages are
        freed or no candidate remains; returns pages actually freed."""
        freed = 0
        while freed < need:
            victim = self.peek_evictable()
            if victim is None:
                break
            freed += len(self.evict(victim))
        return freed

    def flush(self) -> int:
        """Evict every unpinned node (KV-store teardown: the device
        arrays holding the cached content are going away)."""
        return self.evict_lru(len(self.nodes))
