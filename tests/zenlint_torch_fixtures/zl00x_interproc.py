"""Interprocedural fixtures for the port: ZL001/ZL005 follow ids and
receipts through locally defined helpers, as the reference's do.

Each violating caller here is invisible to a per-function pass (the
helper's body is legal in isolation; the caller never names a sink).
The correct idioms pin the summaries' restraint: internal translation,
internal consumption, dict custody, and ambiguous names.
"""


class FixtureRunner:

    # -- helpers (legal in isolation) ---------------------------------------

    def _free_pages(self, pool, ids):
        pool._give(ids)

    def _push(self, pool, ids):
        pool._give(ids)

    def _relay(self, pool, ids):
        """The sink is two hops away (needs the fixpoint)."""
        self._push(pool, ids)

    def _translated(self, pool, req):
        return pool.to_physical(req.pages)

    def _park_all(self, pool, req):
        """Pure receipt relay: the caller owns the reclaim receipt."""
        return pool.reclaim(req)

    def _park_outer(self, pool, req):
        return self._park_all(pool, req)

    # -- ZL001 violations across the helper boundary ------------------------

    def free_view_ids_via_helper(self, pool, req):
        self._free_pages(pool, req.pages)  # EXPECT[ZL001]

    def free_view_ids_via_chain(self, pool, req):
        self._relay(pool, req.local_pages)  # EXPECT[ZL001]

    def store_phys_return_on_request(self, pool, req):
        req.pages = self._translated(pool, req)  # EXPECT[ZL001]

    # -- ZL005 violations across the helper boundary ------------------------

    def preempt_discards_relayed_receipt(self, pool, victim):
        self._park_all(pool, victim)  # EXPECT[ZL005]

    def preempt_discards_chained_receipt(self, pool, victim):
        self._park_outer(pool, victim)  # EXPECT[ZL005]

    # -- correct idioms (must NOT be flagged) -------------------------------

    def free_translated_ids_via_helper(self, pool, req):
        self._free_pages(pool, pool.to_physical(req.pages))

    def relayed_receipt_consumed(self, pool, victim):
        ids = self._park_all(pool, victim)
        self.snapshot(ids)
        return ids

    def _detach(self, cache, nodes):
        released = cache.unpin(nodes)
        self.count += released
        return released

    def detach_ignoring_count(self, cache, req):
        self._detach(cache, req.prefix_nodes)

    def _park_info(self, pool, req):
        ids = pool.reclaim(req)
        return {"req": req.req_id, "ids": ids}
