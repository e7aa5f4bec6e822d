"""ZL004 fixtures for the port: host synchronization inside serving hot
paths.

Device values are the results of the model's calls and of ``torch.*``
ops on them, ``.to(<device>)``, the runner's device state and
``torch.Tensor``-annotated parameters; the one legal sync idiom is a
single batched ``.tolist()`` whose RESULT is then indexed host-side (the
fetch itself is still flagged -- the real runner carries the justified
suppression).
"""

import numpy as np
import torch


class SyncRunner:

    # -- violations ---------------------------------------------------------

    def decode(self, req):
        logits = self.model.decode_step(self.params, req.tokens)
        tok = logits.item()  # EXPECT[ZL004]
        host = logits.cpu()  # EXPECT[ZL004]
        arr = logits.numpy()  # EXPECT[ZL004]
        moved = logits.to("cpu")  # EXPECT[ZL004]
        val = int(logits[0])  # EXPECT[ZL004]
        if logits[0] > 0:  # EXPECT[ZL004]
            tok = 0
        torch.cuda.synchronize()  # EXPECT[ZL004]
        return tok, host, arr, moved, val, self._margins(logits)

    def prefill(self, req):
        toks = torch.as_tensor(req.tokens).to(self.device)
        probs = torch.softmax(self.model.prefill(self.params, toks), -1)
        first = probs.argmax(-1).tolist()  # EXPECT[ZL004]
        count = self._count(req)
        return first, count, float(probs[0, 0])  # EXPECT[ZL004]

    def _margins(self, logits: torch.Tensor):
        """Reached from ``decode`` through ``self.``: hot as well."""
        return np.asarray(logits.topk(2).values)  # EXPECT[ZL004]

    def _count(self, req):
        """``.item()`` syncs whatever its operand."""
        return req.counter.item()  # EXPECT[ZL004]

    # -- correct idioms (must NOT be flagged) -------------------------------

    def _decode_fn(self, req):
        logits = self.model.decode_step(self.params, req.tokens)
        fetched = logits.argmax(-1).tolist()  # EXPECT[ZL004]
        first = int(fetched[0])
        if fetched[0] > 0:
            first += 1
        rows = int(logits.shape[0]) + logits.numel()
        if logits is None or self.cache is None:
            first = 0
        host = torch.zeros((4, 1), dtype=torch.long)
        return first, rows, host.tolist(), self._count_host(req)

    def _count_host(self, req):
        staged = torch.randint(0, 8, (1, 4))
        return int(staged[0, 0]) + len(req.tokens)

    def report(self, req):
        logits = self.model.decode_step(self.params, req.tokens)
        return float(logits[0])
