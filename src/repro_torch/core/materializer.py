"""The plan of one invocation: the counterpart of
``repro/core/materializer.py``'s ``Plan``, with only the fields the
training step reads.

The reference's materializer also places the job on a mesh and walks a
locality ladder of sharding and memory choices to fill them in; the port
runs on one card and takes the plan as given, until the control-plane
slice brings that ladder across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Plan:
    """Execution strategy of one training invocation (the reference's
    defaults)."""
    remat: str = "none"                     # none | full
    microbatch: int = 1                     # gradient-accumulation steps
    attn_impl: str = "naive"                # kept for parity (ImplConfig)
    grad_compression: Optional[str] = None  # "int8": fake-quantized grads
    loss_chunk: int = 0                     # chunked-CE streaming (0 = off)
