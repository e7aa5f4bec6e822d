"""ZL002 fixtures for the port: aliases of device state read after a
call that rebinds it.

Eager PyTorch donates no buffers; the port's hazard is a local alias of
a runner's or a store's tensors (``layers``, ``cache``, ``params``,
``k_pages``, ``v_pages``) taken before ``park``/``unpark``/
``migrate_out``/``migrate_in``/``drop_arrays``/``ensure_arrays`` and
read after it, which reads the tensors the owner no longer holds.
"""


class FixtureRunner:

    # -- violations ---------------------------------------------------------

    def read_after_park(self, drained):
        kp = self.store.k_pages[0]
        state = self.park(drained)
        return state, kp.sum()  # EXPECT[ZL002]

    def alias_after_unpark(self, runner, state, restored):
        layers = runner.layers
        runner.unpark(state, restored)
        return layers[0]  # EXPECT[ZL002]

    def write_through_stale_alias(self, store, page, value):
        vp = store.v_pages[1]
        store.drop_arrays()
        store.ensure_arrays()
        vp[page] = value  # EXPECT[ZL002]

    # -- correct idioms (must NOT be flagged) -------------------------------

    def reread_after_unpark(self, runner, state, restored):
        layers = runner.layers
        runner.unpark(state, restored)
        layers = runner.layers
        return layers[0]

    def alias_used_before_the_call(self, drained):
        cache = self.cache
        total = cache.sum()
        state = self.park(drained)
        return state, total

    def owner_read_after_the_call(self, runner, state, restored):
        runner.unpark(state, restored)
        return runner.store.k_pages[0]
