"""Deliberately broken file for the gate's self-check: the port's
zenlint gate must exit non-zero on it, proving the gate actually fails
when an invariant is violated (a gate that cannot fail gates nothing)."""


def free_view_ids(pool, req):
    pool._give(req.pages)  # EXPECT[ZL001]


class SeededRunner:
    def decode(self, req):
        logits = self.model.decode_step(self.params, req.tokens)
        return logits.argmax(-1).tolist()  # EXPECT[ZL004]
