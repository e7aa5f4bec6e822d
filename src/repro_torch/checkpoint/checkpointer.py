"""Checkpoints with atomic commit, in the reference's on-disk format.

A copy of ``repro/checkpoint/checkpointer.py`` for trees of torch
tensors, writing exactly what the reference writes, so a cut taken by
either package restores in the other:

    ckpt_dir/step_00000123.tmp/   -> written, fsynced
        manifest.json            (step, extra, and per leaf: key, file,
                                  shape, dtype, hash of the file's head)
        arr_00000.npy ...        (one file per leaf)
    ckpt_dir/step_00000123/      (atomic rename = commit record)

Leaves are numbered in the reference's pytree order -- dict keys sorted
at every level -- and keyed by their ``/``-joined dict path.  numpy has
no bfloat16, so a bf16 leaf is stored as its uint16 bits with
``"dtype": "bfloat16"`` in the manifest.  A restored leaf takes the
dtype and the device of the matching leaf of the ``like`` tree.  Writes
can run on a background thread (:class:`AsyncCheckpointer`) from a host
copy taken before the call returns.

A tree sharded over a mesh of ranks is saved with its ``layouts`` (the
planner's ``Layout`` of each leaf): every rank takes part in gathering
each whole leaf and rank 0 alone writes it, in the same format, so the
cut does not depend on the mesh it was taken on.  ``restore_checkpoint``
with ``shardings`` reads the whole leaves and keeps this rank's block of
each under the new layouts -- onto any mesh (the reference's elastic
restore).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.collectives import gather_full


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Host numpy array + logical dtype name (bf16 as its uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_saved(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))          # a copy; keeps 0-d


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) in the reference's pytree order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(
                    tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def _gathered(tree: Any, layouts: Any) -> Optional[Any]:
    """The whole leaves of a sharded tree (``layouts``: a tree of the same
    structure) as host copies on rank 0 (None on the other ranks),
    gathered one leaf at a time so that no rank holds more than one whole
    leaf on its device; every rank must call it."""
    rank0 = dist.get_rank() == 0
    host = []
    for (_, leaf), (_, lay) in zip(_flatten_with_paths(tree),
                                   _flatten_with_paths(layouts)):
        full = gather_full(leaf, lay)
        if rank0:
            host.append(full.detach().to("cpu", copy=True))
        del full
    return _rebuild(tree, iter(host)) if rank0 else None


def _rebuild(like: Any, it) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    return next(it)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict] = None,
                    layouts: Any = None) -> str:
    """Blocking save with atomic commit.  Returns the committed path.
    With ``layouts`` (a sharded tree), every rank must call it: the
    whole leaves are gathered, rank 0 writes them, and every rank returns
    once the cut is committed."""
    if layouts is not None:
        host = _gathered(tree, layouts)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if host is not None:
            save_checkpoint(ckpt_dir, step, host, extra)
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, logical = _to_savable(torch.as_tensor(leaf))
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
        with open(os.path.join(tmp, fname), "rb") as f:
            digest = hashlib.sha256(f.read(1 << 20)).hexdigest()[:16]
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": logical, "hash_head": digest})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int], like: Any,
                       shardings: Any = None) -> Tuple[Any, Dict, int]:
    """Restore into the structure of ``like`` (validates shapes; each leaf
    takes the dtype and device of its ``like`` leaf).  Returns (tree,
    extra, step); ``step`` None means the latest.  With ``shardings`` (a
    tree of the planner's ``Layout``s of ``like``'s structure) each leaf
    is this rank's block of the saved whole leaf under its layout, and
    ``like`` holds this rank's blocks."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    saved = {ent["key"]: ent for ent in manifest["leaves"]}

    def load(key: str, leaf: torch.Tensor, layout) -> torch.Tensor:
        if key not in saved:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        ent = saved[key]
        t = _from_saved(np.load(os.path.join(path, ent["file"]),
                                allow_pickle=False), ent["dtype"])
        whole = tuple(t.shape)
        if layout is not None:
            t = layout.local(t).contiguous()
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {whole} "
                             f"({tuple(t.shape)} on this rank) != restore "
                             f"target {tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    def build(tree, lay, prefix):
        if isinstance(tree, dict):
            return {k: build(v, None if lay is None else lay[k],
                             f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return load(prefix, tree, lay)

    return build(like, shardings, ""), manifest["extra"], step


def _host_copy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one write in
    flight, keeping the newest ``keep`` cuts."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: List[int] = []

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False, layouts: Any = None):
        """With ``layouts`` (a sharded tree) every rank must call it: the
        whole leaves are gathered here, on the calling thread, and rank 0
        alone writes them."""
        self.wait()
        # host copy BEFORE returning control: the optimizer updates the
        # state in place, so the cut must not alias it
        if layouts is not None:
            host_tree = _gathered(tree, layouts)
            if host_tree is None:
                return
        else:
            host_tree = _host_copy(tree)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self.saved_steps.append(step)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def _gc(self):
        steps = sorted(self.saved_steps)
        while len(steps) > self.keep:
            s = steps.pop(0)
            path = os.path.join(self.ckpt_dir, f"step_{s:08d}")
            if os.path.exists(path):
                shutil.rmtree(path)
            self.saved_steps.remove(s)
