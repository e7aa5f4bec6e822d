"""PyTorch/CUDA port of the Zenix serving data plane and training path,
for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its
module names (``configs``, ``core.*``, ``runtime.*``, ``serving.*``,
``models.*``, ``kernels.*``, ``training.*``, ``data.pipeline``,
``checkpoint.*``, ``obs.*``, ``launch.serve``, ``launch.train``) so each
counterpart is easy to find.  The launchers submit applications to the
resource-centric runtime (``runtime.Cluster`` with a
``runtime.TorchExecutor``), as the reference's do.  It imports ``torch``, numpy and the
standard library only -- never ``jax`` and never a module of ``repro`` --
and keeps its own copies of what it needs.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, as the tests do); on a CPU tensor every kernel wrapper
takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA by default.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device exists -- the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
