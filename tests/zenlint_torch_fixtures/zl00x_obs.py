"""Observability fixtures for the port: ZL004 vs the tracer idiom.

Never imported at runtime -- parsed by the analyzer only.  The tracing
discipline (``repro_torch/obs/trace.py``) is guard-and-append with HOST
scalar args; the tempting mistake is stuffing a device value into an
event's args dict, which forces a transfer and a sync inside the
decode/prefill hot path -- the exact stall ZL004 exists to catch.
"""

from repro_torch.obs import trace as obs_trace


class TracedRunner:

    # -- violations: tracer args that sync a device value -------------------

    def decode(self, req):
        logits = self.model.decode_step(self.params, req.tokens)
        t = obs_trace.TRACER
        if t is not None:
            tok = int(logits[0].argmax())  # EXPECT[ZL004]
            t.instant("engine", "decode_step", req.req_id, {"tok": tok})
        return logits

    def prefill(self, req):
        scores = self.model.prefill(self.params, req.tokens).softmax(-1)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("request", "prefill", req.req_id,
                      {"score": float(scores[0, 0])})  # EXPECT[ZL004]
        return scores


class CleanTracedRunner:

    # -- correct idioms (must NOT be flagged): host-scalar args only --------

    def decode(self, req):
        logits = self.model.decode_step(self.params, req.tokens)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("engine", "decode_step", req.req_id,
                      {"batch": logits.shape[0], "queue": len(req.queue)})
        return logits

    def prefill(self, req):
        toks = self.model.prefill(self.params, req.tokens)
        t = obs_trace.TRACER
        if t is not None:
            t.instant("request", "prefill", req.req_id,
                      {"prompt_len": req.prompt_len,
                       "tokens": toks.size(1)})
        return toks
