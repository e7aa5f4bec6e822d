"""ZL003 fixtures for the port: per-request values becoming compile or
capture keys.

Hot-path scoping comes from the class/method naming convention
(``*Runner.decode/prefill`` and the helpers they call through
``self.``), so the violating methods live on a ``...Runner`` class and
the same patterns outside a hot path are legal.  ``_graphs`` is the
idiom of a captured decode step: one CUDA graph per padded bucket.
"""

import numpy as np
import torch


def _step_fn(toks):
    return toks


def _next_pow2(n):
    m = 1
    while m < n:
        m *= 2
    return m


class HazardRunner:
    def __init__(self):
        self._step = torch.compile(_step_fn, dynamic=False)
        self._graphs = {}

    def capture(self, width):
        """Not a hot path: fills the bucketed graph table once."""
        self._graphs[width] = torch.cuda.CUDAGraph()
        return self._graphs[width]

    # -- violations ---------------------------------------------------------

    def prefill(self, req):
        fresh = torch.compile(_step_fn)  # EXPECT[ZL003]
        return fresh(req.tokens)

    def decode(self, running, req):
        toks = req.tokens
        out = self._step(toks)  # EXPECT[ZL003]
        buf = np.zeros((len(running), 8))  # EXPECT[ZL003]
        graph = self._graphs[req.prompt_len]  # EXPECT[ZL003]
        return out, buf, graph, self._recapture()

    def _recapture(self):
        g = torch.cuda.CUDAGraph()  # EXPECT[ZL003]
        with torch.cuda.graph(g):  # EXPECT[ZL003]
            self.replay_body()
        return g

    # -- correct idioms (must NOT be flagged) -------------------------------

    def _decode_fn(self, req):
        width = _next_pow2(req.prompt_len)
        staged = np.zeros((self.max_batch, 8))
        padded = ((req.prompt_len + 127) // 128) * 128
        graph = self._graphs.get(width)
        return self._step(staged), padded, graph


class ColdHelper:
    """Same patterns OUTSIDE a hot path: legal (set-up code may stage
    per-request shapes; it runs once, not per token)."""

    def warmup(self, req):
        probe = torch.compile(_step_fn)
        return probe(np.zeros((req.prompt_len,)))
