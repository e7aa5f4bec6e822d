"""Bring the reference's weights into the port.

The reference initializes with ``jax.random``, which PyTorch cannot
replay, so parity runs move its parameters across as numpy arrays.
bf16 arrives either as an ``ml_dtypes`` bfloat16 array (``np.asarray`` of
a JAX array) or as the checkpointer's uint16 bit view; both become
``torch.bfloat16`` tensors holding the same bits.  No JAX is needed here:
the caller does the ``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import param_specs


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One numpy leaf -> tensor; bf16 (ml_dtypes or uint16 bits) stays bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree, as numpy arrays, -> the port's
    tensors on ``device``.  Keys and shapes are checked against the port's
    spec tree, so a layout drift fails here and not deep in a forward."""
    dev = resolve_device(device)

    def convert(sub, specs, path):
        if set(sub) != set(specs):
            raise ValueError(f"bridge: keys at {path or '/'} are "
                             f"{sorted(sub)}, the port expects "
                             f"{sorted(specs)}")
        out = {}
        for key, spec in specs.items():
            where = f"{path}/{key}"
            if isinstance(spec, dict):
                out[key] = convert(sub[key], spec, where)
                continue
            t = tensor_from_numpy(sub[key], dev)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"bridge: {where} has shape "
                                 f"{tuple(t.shape)}, expected {spec.shape}")
            out[key] = t
        return out

    return convert(tree, param_specs(cfg), "")
