"""Data pipeline: a copy of ``repro/data/pipeline.py`` (numpy only), so
the same seed gives the same batches in both packages.

Synthetic data is generated from a seeded Markov-ish process so training
loss *decreases* measurably (structure to learn) while remaining fully
offline/deterministic.  The loader prefetches on a background thread
(double buffering) and slices per-host shards for multi-host launches;
on a mesh of ranks each rank takes its block of the global batch's rows
(:func:`rank_rows`)."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 64        # size of the latent transition table
    host_count: int = 1
    host_index: int = 0


class SyntheticLM:
    """Deterministic structured token stream: x_{t+1} = f(x_t) + noise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.table = rng.integers(0, cfg.vocab_size,
                                  size=(cfg.structure,), dtype=np.int64)
        self._step = 0

    def _batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1 + step)
        b = cfg.global_batch // cfg.host_count
        start = rng.integers(0, cfg.structure, size=(b, 1))
        t = np.arange(cfg.seq_len + 1)[None, :]
        latent = (start + t) % cfg.structure
        toks = self.table[latent]
        noise = rng.random((b, cfg.seq_len + 1)) < 0.05
        rand = rng.integers(0, cfg.vocab_size, size=(b, cfg.seq_len + 1))
        toks = np.where(noise, rand, toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self._step
        while True:
            yield self._batch(step)
            step += 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Random access by step index: exact replay after restart (the
        recovery path re-reads the same batches from the last cut)."""
        return self._batch(step)


def rank_rows(batch: Dict[str, np.ndarray], blocks: int,
              index: int) -> Dict[str, np.ndarray]:
    """Block ``index`` of ``blocks`` contiguous blocks of rows of every
    array of a global batch: a rank's rows when the batch dim is split
    over ``blocks`` ranks (the planner's ``batch_spec``; every rank draws
    the same global batch from the seed)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % blocks:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split into "
                             f"{blocks} blocks")
        n = v.shape[0] // blocks
        out[k] = v[index * n:(index + 1) * n]
    return out


class PrefetchLoader:
    """Background-thread prefetch with bounded depth (double buffering)."""

    def __init__(self, source: Iterator[Dict[str, np.ndarray]],
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._src = source
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        for item in self._src:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass


def make_loader(cfg: DataConfig, start_step: int = 0,
                prefetch: int = 2) -> PrefetchLoader:
    src = SyntheticLM(cfg)
    src._step = start_step
    return PrefetchLoader(iter(src), depth=prefetch)
