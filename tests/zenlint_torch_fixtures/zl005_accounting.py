"""ZL005 fixtures for the port: reclaim/park receipts must be consumed
on every path (the reference's rule, over the port's verbs)."""


class FixtureScheduler:

    # -- violations ---------------------------------------------------------

    def preempt_discards_receipt(self, pool, victim):
        pool.reclaim(victim)  # EXPECT[ZL005]

    def park_then_early_return(self, scheduler, app, urgent):
        freed = scheduler.park(app)
        if urgent:
            return None  # EXPECT[ZL005]
        self.ledger.append(freed)
        return freed

    def runner_park_snapshot_dropped(self, runner, drained):
        runner.park(drained)  # EXPECT[ZL005]

    # -- correct idioms (must NOT be flagged) -------------------------------

    def reclaim_and_snapshot(self, pool, victim):
        ids = pool.reclaim(victim)
        self.snapshot(ids)
        return ids

    def park_and_propagate(self, scheduler, app):
        return scheduler.park(app)

    def drain_consumed_in_loop(self, pool):
        ids = pool.drain()
        for page in ids:
            self.copy_out(page)

    def regrant_checked(self, pool, app):
        ok = pool.regrant(app)
        if not ok:
            self.requeue(app)
