"""Model execution backend of the port's serving engine.

Counterpart of ``repro/serving/model_runner.py``.  The engine owns
admission, paging and preemption; a :class:`ModelRunner` owns the device
state and the two entry points the engine drives:

* ``prefill(req)``  -- forward over the prompt, writing its KV into the
  request's pages, and the first token;
* ``decode(running)`` -- one batched greedy decode step.

:class:`PagedRunner` keeps KV in per-layer ``(pool_pages + 1, PAGE_SIZE,
KV, hd)`` bf16 page tensors (the last page is a write-only trash page for
padded batch lanes) and runs three Hopper kernels: the flash-attention
forward for prefill, the paged-attention decode, and RMSNorm.  It serves
RoPE stacks mixing global and sliding-window (``ATTN_LOCAL``) layers:
global layers keep a page table that grows with the sequence; with
``use_rings`` a local layer keeps a fixed ring of ``ring_pages`` pages a
request from the pool's local id space, token ``p`` at ring slot ``p %
(ring_pages * PAGE_SIZE)``, and the decode kernel recovers each slot's
position (``ring=True``).  A stack with local layers prefills natively;
a pure-global stack prefills prompts of at most ``chunk_pages`` pages
natively and longer ones in chunks of ``chunk_pages`` pages, each
attending over the earlier pages gathered in front of it (``q_offset`` =
the chunk's start).  Decode pads the batch to ``max_batch`` and buckets
the table width to a power of two, as the reference does (the shapes a
later CUDA-graph capture will key on).

The page tensors live in a :class:`KVArrayStore` keyed by
:func:`kv_shape_key`.  On a pod-shared pool (``serving/tenancy.py``)
every same-shape paged tenant, and every replica of one app, is handed
the pod's one store and reads and writes the same tensors; requests
carry view-local page ids, which the runner translates through the
engine pool's ``to_physical`` at every index it builds (prefill writes,
context pages, decode write slots and tables).  With a prefix cache
(``serving/prefix_cache.py``, pure-global stacks) a request's table
starts with the cache's read-only physical pages, prefill computes only
the uncached suffix in chunks on the absolute ``chunk_pages`` grid, the
first of which takes the cached partial page's lead slots in place of
its own (the copy-on-write), and the prompt's new pages are donated to
the cache after prefill.  A paged replica's drained requests migrate to
a sibling replica with their KV (``migrate_out``/``migrate_in``).

Where the reference donates its page arrays to ``jit`` so XLA updates them
in place and writes the result back to the store, the port writes the
store's page tensors in place (``index_put_``), so co-tenants and
replicas simply index the one store.

:class:`DenseRunner` keeps a preallocated per-slot dense cache of
``cache_len`` tokens (KV laid out (B, KV, S, hd); Mamba-2 and RWKV-6
states) and drives ``Model.prefill`` and ``Model.decode_step``, which
write into it in place.  It serves global-attention, Mamba-2, RWKV-6,
zamba2's hybrid and the MoE stacks, and phi-3-vision's text prompts,
through the flash-attention forward (prefill), the decode-attention
kernel, the SSD and WKV scan kernels, and RMSNorm.  As the reference's,
it passes a prompt's tokens only: image tokens and whisper's frame
features go through ``Model.prefill`` itself, and the runner refuses
whisper, whose prefill cannot run without its frames.
It copies the reference's behaviour exactly, since token parity depends
on it: prompts are never padded, and decode runs the whole slot batch at
one shared position.  A sliding-window layer's dense cache is a ring of
``min(cache_len, window)`` slots.  Under a serving plan of a mesh
(``layout``, a ``planner.ServeLayout``; every family but whisper) each
rank holds its blocks of the weights and of the cache (an SSM or WKV
state its heads, a conv or token-shift state whole): its slots are its
block of the lanes over the plan's batch axes, a request's prompt is
prefilled by the ranks that hold its slot, a decode step runs each
rank's lanes, and the first and next tokens are all-gathered over the
batch axes, so that every rank's engine holds the same requests and
tokens.

Idle parking (``autoscale/parking.py``): ``park`` snapshots a runner's
decode state and weights to the host in the checkpointer's array format
(bf16 as its uint16 bits beside its logical dtype) and drops the device
copies -- the dense runner its whole cache too, the paged runner each
drained request's private pages, and the store's page tensors when no
active co-tenant still decodes through them -- so the card's memory
really comes back; ``unpark`` rebuilds them on the runner's own device
and writes each restored request's KV into its fresh grants.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.analysis import zensan
from repro_torch.checkpoint.checkpointer import _from_saved, _to_savable
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.model import (Model, check_family, embed_tokens,
                                      gather_lanes, init_params, lane_block,
                                      layer_params, pageable, param_specs)
from repro_torch.models.transformer import ImplConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.kv_cache import (PAGE_SIZE, PageGroups, Request,
                                         page_table)
from repro_torch.serving.serve_step import impl_from_plan

KV_DTYPE = torch.bfloat16


def kv_shape_key(cfg: ModelConfig, pool_pages: int, *,
                 use_rings: bool = True) -> Tuple:
    """KV shape signature deciding which paged tenants may alias one set
    of page tensors: layer count, pool geometry, KV head layout, dtype,
    and (when rings are on) WHICH layers are rings -- ring layers are
    indexed from the local id space, so a ring tenant and a no-ring
    tenant of the same config must not share tensors.  Equal to the
    reference's key for the same config."""
    groups = PageGroups.from_config(cfg)
    rings = bool(use_rings) and groups.local_layers > 0
    return (cfg.num_layers, int(pool_pages), PAGE_SIZE, cfg.num_kv_heads,
            cfg.head_dim, str(KV_DTYPE).removeprefix("torch."),
            tuple(k == ATTN_LOCAL for k in cfg.pattern) if rings else None)


class KVArrayStore:
    """The page tensors of one KV shape: per layer one K and one V tensor
    of ``(pool_pages + 1, PAGE_SIZE, KV, hd)``, the last page being a
    write-only trash page for padded batch lanes.  A ring layer's tensors
    are indexed by local (ring) ids, a global layer's by global ids.

    On a pod-shared pool it is the aliasing unit: registered on the
    ``SharedPagePool`` under its :func:`kv_shape_key`, read and written
    by every same-shape paged tenant's runner at pod-unique physical ids,
    so N same-model tenants cost one pool of device memory.  Its
    ``free_local`` is then the shared physical id space of the ring
    pages (None for shapes without rings).  ``users`` are the app names
    aliasing it; the last one's release drops the tensors."""

    def __init__(self, key: Tuple, device: torch.device):
        (num_layers, pool_pages, page, kvh, hd, dtype, ring_pat) = key
        self.key = key
        self.num_layers = num_layers
        self.device = torch.device(device)
        self.dtype = getattr(torch, dtype)
        self.page_shape = (pool_pages + 1, page, kvh, hd)
        self.k_pages: Optional[List[torch.Tensor]] = None
        self.v_pages: Optional[List[torch.Tensor]] = None
        self.free_local: Optional[List[int]] = (
            list(range(pool_pages)) if ring_pat and any(ring_pat) else None)
        self.users: set = set()
        self.ensure_arrays()

    def ensure_arrays(self) -> None:
        """Make the page tensors (again, after :meth:`drop_arrays`)."""
        if self.k_pages is None:
            self.k_pages = [torch.zeros(self.page_shape, dtype=self.dtype,
                                        device=self.device)
                            for _ in range(self.num_layers)]
            self.v_pages = [torch.zeros(self.page_shape, dtype=self.dtype,
                                        device=self.device)
                            for _ in range(self.num_layers)]

    def drop_arrays(self) -> None:
        """Free the page tensors: drop the store's references, then hand
        the allocator's cached blocks back to the card, so that the
        device memory really returns (a runner reads the tensors through
        the store and holds no reference of its own)."""
        dropped = self.k_pages is not None
        self.k_pages = None
        self.v_pages = None
        if dropped and self.device.type == "cuda":
            torch.cuda.empty_cache()

    def device_bytes(self) -> int:
        """Bytes of the page tensors (the stats view's gauge; 0 once
        dropped)."""
        if self.k_pages is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in self.k_pages + self.v_pages)


def synth_prompt(req_id: str, prompt_len: int, vocab: int) -> torch.Tensor:
    """Deterministic synthetic prompt (CPU int64, (1, prompt_len)) from a
    stable digest of the request id.  Not the reference's tokens (that
    uses ``jax.random``): parity runs pass ``prompt_tokens``."""
    gen = torch.Generator().manual_seed(zlib.crc32(req_id.encode()) % 2**31)
    return torch.randint(0, vocab, (1, prompt_len), generator=gen)


def prompt_for(req: Request, vocab: int) -> torch.Tensor:
    """(1, prompt_len) prompt tokens: explicit ``req.prompt_tokens`` win."""
    if req.prompt_tokens is not None:
        if len(req.prompt_tokens) != req.prompt_len:
            raise ValueError(f"{req.req_id}: {len(req.prompt_tokens)} prompt "
                             f"tokens for prompt_len {req.prompt_len}")
        return torch.tensor(req.prompt_tokens, dtype=torch.long)[None, :]
    return synth_prompt(req.req_id, req.prompt_len, vocab)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class _Leaf:
    """A tensor's place in a host snapshot's skeleton."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def tree_to_host(tree) -> Tuple[list, object]:
    """Host snapshot of a tree of tensors (nested dicts, lists, tuples):
    its leaves in the checkpointer's array format, each ``(numpy array,
    logical dtype)`` with bf16 as its uint16 bits, and the tree's
    skeleton with each tensor's place marked."""
    leaves: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(_to_savable(x))
            return _Leaf(len(leaves) - 1)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    skeleton = walk(tree)
    return leaves, skeleton


def tree_from_host(saved: Tuple[list, object], device: torch.device):
    """The tree of :func:`tree_to_host` on ``device``, bit-equal."""
    leaves, skeleton = saved

    def walk(x):
        if isinstance(x, _Leaf):
            return _from_saved(*leaves[x.index]).to(device)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(skeleton)


class ModelRunner:
    """Backend interface the engine's step functions are bound to."""

    backend = "null"

    def __init__(self, record_margins: bool = False):
        self.engine = None
        self.generated: Dict[str, List[int]] = {}
        # parity checks: the top-1 minus top-2 logit gap of every emitted
        # token, per request (a near-tie may flip under other roundings),
        # and, recorded with them, the top-1 logit (the scale of its bf16
        # rounding)
        self.margins: Optional[Dict[str, List[float]]] = (
            {} if record_margins else None)
        self.tops: Dict[str, List[float]] = {}

    def bind(self, engine) -> None:
        self.engine = engine

    def prefill(self, req: Request) -> None:
        raise NotImplementedError

    def decode(self, running: List[Request]) -> None:
        raise NotImplementedError

    def finish(self, req: Request) -> None:
        """Completion hook: hand the tokens back to the request and evict
        the runner's entry for it."""
        toks = self.generated.pop(req.req_id, None)
        if toks is not None:
            req.output_tokens = toks

    # -- idle parking (autoscale/parking.py) ---------------------------------
    def _release_device_memory(self) -> None:
        """Hand the allocator's cached blocks back to the card, so the
        bytes a park dropped are free for other processes too."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def park(self, drained: List[Tuple[Request, Tuple[List[int],
                                                      List[int]]]]) -> Dict:
        """Snapshot the decode state and the weights to the host
        (:func:`tree_to_host`) and drop the device copies, so a parked
        app's device memory really comes back: the scheduler hands back
        every byte of the job, which must not leave weights resident.
        ``drained`` is the engine's ``drain()`` output: (request, (global
        page ids, local ring page ids) it held), physical ids whose page
        contents are still intact on the card."""
        state = {"generated": {k: list(v)
                               for k, v in self.generated.items()}}
        if getattr(self, "params", None) is not None:
            state["params"] = tree_to_host(self.params)
            self.params = None
        return state

    def unpark(self, state: Dict, restored: List[Request]) -> None:
        """Rebuild the device state of a ``park`` snapshot on the runner's
        own device.  ``restored`` are the drained requests that got their
        pages again (fresh ids in ``req.pages``); the caller requeues the
        rest, which prefill again from scratch."""
        if "params" in state:
            self.params = tree_from_host(state["params"], self.device)
        self.generated = {k: list(v) for k, v in state["generated"].items()}

    # -- replica migration (serving/router.py) -------------------------------
    #: replicas sharing one set of page tensors can hand running requests
    #: to each other without loss (paged); slot-indexed caches cannot
    #: (dense), so their requests take the requeue path instead
    can_migrate = False

    def migrate_out(self, drained: List[Tuple[Request, Tuple[List[int],
                                                             List[int]]]]
                    ) -> Dict:
        """Decode state of the drained requests for a move to a sibling
        replica (``drained`` is the engine's ``drain()`` output)."""
        return {"generated": {req.req_id: self.generated.pop(req.req_id, [])
                              for req, _ in drained}}

    def migrate_in(self, state: Dict, restored: List[Request]) -> None:
        """Adopt migrated requests: only their entries merge in, the
        target's own running requests keep theirs."""
        for req in restored:
            self.generated[req.req_id] = list(
                state["generated"].get(req.req_id, []))

    def _record_margins(self, reqs: List[Request], logits: torch.Tensor):
        """logits: one (V,) row per request in ``reqs``."""
        if self.margins is None:
            return
        # zenlint-torch: ignore[ZL004] -- margins are recorded only when
        # asked (parity checks): one fetch of the step's (gap, top-1) pairs
        self._record_top2(reqs, top2(logits).tolist())

    def _record_top2(self, reqs: List[Request], pairs) -> None:
        """``pairs``: one (gap, top-1 logit) per request in ``reqs``."""
        for req, (gap, top) in zip(reqs, pairs):
            self.margins.setdefault(req.req_id, []).append(gap)
            self.tops.setdefault(req.req_id, []).append(top)


def top2(logits: torch.Tensor) -> torch.Tensor:
    """Each row's (top-1 minus top-2 logit, top-1 logit), (..., 2)."""
    top = logits.topk(2, dim=-1).values
    return torch.stack([top[..., 0] - top[..., 1], top[..., 0]], dim=-1)


class DenseRunner(ModelRunner):
    """Slot-indexed dense cache; prefill through ``Model.prefill`` and
    decode through ``Model.decode_step`` (the reference's
    ``DenseRunner``).  With ``layout`` (a serving plan over a mesh) the
    rank's blocks of the weights (``params`` as they are, or drawn from
    ``seed`` block by block) and of the cache, the rank's block of the
    slots (module doc)."""

    backend = "dense"

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 max_batch: int = 4, cache_len: int = 256,
                 params: Optional[dict] = None, device: DeviceLike = None,
                 record_margins: bool = False, layout=None):
        super().__init__(record_margins)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.cache_len = cache_len
        # an encoder-decoder is refused first, on one card and under a
        # layout alike
        if cfg.is_encdec:
            raise ValueError(
                f"backend='dense' serves prompts of tokens; {cfg.name} is an "
                "encoder-decoder whose prefill needs its encoder's frame "
                "features: drive Model.prefill(..., enc_feats=...) and "
                "Model.decode_step directly")
        self.model = (Model(cfg, ImplConfig(remat="none")) if layout is None
                      else Model(cfg, impl_from_plan(layout.plan, layout.mesh),
                                 layout=layout))
        self.cache = self.model.init_cache(max_batch, cache_len, self.device)
        self.params = (init_params(cfg, seed, self.device, layouts=None
                                   if layout is None else
                                   layout.params(cfg, param_specs(cfg)))
                       if params is None else params)
        self.slots: Dict[str, tuple] = {}      # req_id -> (slot, prompt_len)
        # this rank's block of the slots: (blocks, its block)
        self.lanes = lane_block(self.model.lanes)
        # prompts this rank prefilled (its slots' requests)
        self.local_prefills = 0

    def _rows(self) -> slice:
        n, i = self.lanes
        per = self.max_batch // n
        return slice(i * per, (i + 1) * per)

    def prefill(self, req: Request) -> None:
        """Forward over the whole prompt -- never padded or bucketed: the
        recurrent state after padded tokens cannot be masked back out --
        writing its decode state into the request's slot.  On a mesh only
        the ranks holding the slot run it (the others join its weight
        gathers where the plan has FSDP: ``Model.join_gathers``); its
        first token (and its top-2 gap) reach every rank from them."""
        toks = prompt_for(req, self.cfg.vocab_size).to(self.device)
        # evict slots of preempted requests (the engine re-queues them;
        # only completion frees a slot via finish) before picking one
        running_ids = {r.req_id for r in self.engine.running}
        for rid in list(self.slots):
            if rid not in running_ids:
                del self.slots[rid]
        if req.req_id in self.slots:      # re-admission after preemption
            slot = self.slots[req.req_id][0]
        else:
            slot = min(set(range(self.max_batch))
                       - {s for s, _ in self.slots.values()})
        self.slots[req.req_id] = (slot, req.prompt_len)
        rows, n = self._rows(), self.lanes[0]
        first, pair = None, [0.0, 0.0]
        if rows.start <= slot < rows.stop:
            logits, _ = self.model.prefill(self.params, toks, self.cache_len,
                                           cache=self.cache,
                                           slot=slot - rows.start)
            self.local_prefills += 1
            # zenlint-torch: ignore[ZL004] -- the first token: once per
            # request (not per token), and the engine needs its id to
            # seed decode
            first = int(logits[0, -1].argmax())
            if self.margins is not None:
                # zenlint-torch: ignore[ZL004] -- margins only when asked
                # (parity checks), once per request
                pair = top2(logits[0, -1]).tolist()
        else:
            self.model.join_gathers(self.params)
        if n > 1:
            # the holders' token and (gap, top) to every rank, by block
            # order
            mine = torch.tensor([[-1.0 if first is None else first] + pair],
                                dtype=torch.float64, device=self.device)
            # zenlint-torch: ignore[ZL004] -- on a mesh the holders' first
            # token and top-2 reach every rank: one gathered fetch a request
            first, *pair = gather_lanes(mine, self.model.lanes)[
                slot // (rows.stop - rows.start)].tolist()
            first = int(first)
        if self.margins is not None:
            self._record_top2([req], [pair])
        self.generated[req.req_id] = [first]

    def decode(self, running: List[Request]) -> None:
        """One step for the whole slot batch at ONE shared position, the
        largest ``prompt_len + generated`` of the running requests, as the
        reference does: every lane's KV is written at that slot and every
        lane attends over ``[0, pos]`` (a shorter request's cache holds
        zero K/V rows in between, which take part in its softmax), and
        RWKV-6's sinusoidal position is that ``pos`` too.  Idle slots run
        token 0; their state is overwritten by the next prefill.  On a
        mesh each rank runs its block of the slots, and the next tokens
        (and top-2 gaps) are all-gathered over the batch axes."""
        if not running:
            return
        s = zensan.SAN
        if s is not None:
            s.dense_state(self, running)
        toks = np.zeros((self.max_batch, 1), np.int64)
        pos = 0
        for req in running:
            slot, plen = self.slots[req.req_id]
            toks[slot, 0] = self.generated[req.req_id][-1]
            pos = max(pos, plen + req.generated)
        logits, _ = self.model.decode_step(
            self.params, torch.from_numpy(toks[self._rows()]).to(self.device),
            self.cache, pos)
        slots = [self.slots[r.req_id][0] for r in running]
        if self.margins is not None:
            pairs = gather_lanes(top2(logits[:, -1]), self.model.lanes)
            # zenlint-torch: ignore[ZL004] -- margins only when asked
            # (parity checks): one batched fetch of the step's pairs
            self._record_top2(running, pairs[slots].tolist())
        # zenlint-torch: ignore[ZL004] -- the one batched device->host
        # fetch of the step: the engine needs the next tokens' ids
        nxt = gather_lanes(logits[:, -1].argmax(-1),
                           self.model.lanes).tolist()
        for req, slot in zip(running, slots):
            self.generated[req.req_id].append(nxt[slot])

    def finish(self, req: Request) -> None:
        super().finish(req)
        self.slots.pop(req.req_id, None)

    def park(self, drained):
        """The dense cache is one tree of per-slot tensors: snapshot every
        one to the host with the weights, and drop the device copies."""
        state = super().park(drained)
        state["cache"] = tree_to_host(self.cache)
        state["slots"] = dict(self.slots)
        self.cache = None
        self._release_device_memory()
        return state

    def unpark(self, state, restored):
        super().unpark(state, restored)
        self.cache = tree_from_host(state["cache"], self.device)
        self.slots = dict(state["slots"])


class PagedRunner(ModelRunner):
    """KV in pool pages; prefill through the flash-attention kernel and
    decode through the paged-attention kernel.  Global layers keep a
    growing page table; with ``use_rings`` sliding-window layers keep a
    fixed ring of ``PageGroups.ring_pages`` pages a request (without, they
    read the growing table through the window mask).

    ``kv_store`` is the pod's registered store for this KV shape (every
    same-shape tenant then reads and writes one set of page tensors);
    without it the runner makes a private store.  ``prefix_cache``
    attaches a :class:`~repro_torch.serving.prefix_cache.PrefixCache`
    (pure-global stacks only)."""

    backend = "paged"

    SUPPORTED_KINDS = (ATTN_GLOBAL, ATTN_LOCAL)

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 pool_pages: int = 128, max_batch: int = 4,
                 use_rings: bool = True,
                 kv_store: Optional[KVArrayStore] = None,
                 prefix_cache=None, chunk_pages: int = 4,
                 params: Optional[dict] = None, device: DeviceLike = None,
                 record_margins: bool = False):
        super().__init__(record_margins)
        if cfg.rope_theta <= 0:
            raise ValueError(f"backend='paged' needs RoPE; {cfg.name} has "
                             f"rope_theta={cfg.rope_theta}")
        check_family(cfg)
        if (any(k not in self.SUPPORTED_KINDS for k in cfg.pattern)
                or not pageable(cfg)):
            raise ValueError(
                f"backend='paged' serves RoPE global/sliding-window "
                f"attention stacks; {cfg.name} has pattern={cfg.pattern} "
                f"family={cfg.family} (serve it with backend='dense')")
        if ATTN_LOCAL in cfg.pattern and cfg.sliding_window <= 0:
            raise ValueError(f"{cfg.name}: ATTN_LOCAL needs sliding_window")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.groups = PageGroups.from_config(cfg)
        self.use_rings = use_rings and self.groups.local_layers > 0
        if prefix_cache is not None and self.groups.local_layers > 0:
            raise ValueError(
                f"prefix_cache=True needs a pure-global attention stack: "
                f"{cfg.name} has sliding-window layers whose ring pages "
                "cannot hold a position-stable shared prefix")
        self.prefix = prefix_cache
        self.chunk_pages = max(int(chunk_pages), 1)
        self.num_layers = cfg.num_layers
        self.pool_pages = pool_pages
        self.trash_page = pool_pages            # padded lanes write here
        key = kv_shape_key(cfg, pool_pages, use_rings=self.use_rings)
        if kv_store is not None and (kv_store.key != key
                                     or kv_store.device != self.device):
            raise ValueError(
                f"kv_store mismatch for {cfg.name}: store key "
                f"{kv_store.key} on {kv_store.device} != runner key {key} "
                f"on {self.device} -- mismatched tenants keep private "
                "tensors")
        self.params = (init_params(cfg, seed, self.device) if params is None
                       else params)
        self.layers = layer_params(self.params, cfg)
        self.shared_kv = kv_store is not None
        self.store = (kv_store if kv_store is not None
                      else KVArrayStore(key, self.device))
        self.store.ensure_arrays()      # a store dropped by parking revives
        # forwards over prompt chunks (a native prefill is one chunk)
        self.prefill_chunks = 0
        # prefill work actually computed, in pages (the prefix cache's
        # savings: cached pages never reach this counter)
        self.prefill_pages_computed = 0
        self.reattach_unpins = 0

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    # -- view-local -> physical id translation -------------------------------
    def _phys(self, ids: List[int]) -> List[int]:
        """Physical ids of a request's global-table pages (identity for a
        private pool; the PoolView's remap on a pod-shared pool)."""
        pool = self.engine.pool if self.engine is not None else None
        return pool.to_physical(ids) if pool is not None else list(ids)

    def _phys_local(self, ids: List[int]) -> List[int]:
        pool = self.engine.pool if self.engine is not None else None
        return pool.to_physical_local(ids) if pool is not None else list(ids)

    def _layer_kind(self, layer: int) -> str:
        return self.cfg.pattern[layer % len(self.cfg.pattern)]

    def _layer_ring(self, layer: int) -> bool:
        """Whether this layer's table is a ring (vs a growing table)."""
        return self.use_rings and self._layer_kind(layer) == ATTN_LOCAL

    def _layer_window(self, layer: int) -> int:
        return (self.cfg.sliding_window
                if self._layer_kind(layer) == ATTN_LOCAL else 0)

    def _cow_copy(self, src_phys: int, dst_phys: int) -> None:
        """Duplicate one physical page's KV on every layer (the insert-time
        self-COW: the donor keeps writing into the copy while the
        original becomes a read-only cached partial page)."""
        for kp, vp in zip(self.store.k_pages, self.store.v_pages):
            kp[dst_phys] = kp[src_phys]
            vp[dst_phys] = vp[src_phys]

    def _block_forward(self, bp, x, positions, mix):
        """One layer: the body shared by prefill and decode.  ``mix(q, k,
        v) -> (B, S, H, hd)`` carries the phase-specific part (KV
        writes and attention through the layer's pages)."""
        cfg = self.cfg
        h = L.rms_norm(x, bp["ln1"]["g"], cfg.norm_eps)
        q, k, v = attn.project_qkv(bp["attn"], h, cfg, positions)
        x = x + attn.attn_out(bp["attn"], mix(q, k, v))
        h = L.rms_norm(x, bp["ln2"]["g"], cfg.norm_eps)
        return x + L.gated_mlp(bp["mlp"], h)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, self.params["ln_f"]["g"], self.cfg.norm_eps)
        return L.unembed(self.params["embed"], x, self.cfg.logit_softcap)

    # -- prefill -------------------------------------------------------------
    def _chunk_forward(self, toks: torch.Tensor, base: int,
                       write_ids: torch.Tensor, ctx_ids: torch.Tensor,
                       ring_ids: Optional[torch.Tensor] = None,
                       ring_src: Optional[torch.Tensor] = None,
                       lead: int = 0, cow_src: Optional[int] = None):
        """Forward over one page-aligned chunk of prompt tokens starting at
        absolute position ``base``: scatter its KV into the ``write_ids``
        pages and attend over the ``ctx_ids`` pages (the prompt's earlier
        pages, cached or computed; none for a native prefill) plus the
        chunk itself.  The copy-on-write is fused: the first ``lead``
        slots of the chunk's first page take page ``cow_src``'s K and V
        (the cached partial page) before the scatter and the attention,
        so the request's private page holds the cached lead plus the new
        suffix and the keys at those positions are the cached ones.  Ring
        layers (a native prefill only) instead write the chunk's pages
        ``ring_src`` at ring pages ``ring_ids`` and attend over the chunk
        through the window.  Returns the final hidden states (1, S, d)."""
        cfg = self.cfg
        s = toks.shape[1]
        n_pg = s // PAGE_SIZE
        positions = base + torch.arange(s, device=self.device)
        x = embed_tokens(cfg, self.params, toks)
        for layer, bp in enumerate(self.layers):
            kp, vp = self.store.k_pages[layer], self.store.v_pages[layer]
            ring = self._layer_ring(layer)
            window = self._layer_window(layer)

            def mix(q, k, v, kp=kp, vp=vp, ring=ring, window=window):
                if lead:
                    k, v = k.clone(), v.clone()
                    k[0, :lead] = kp[cow_src, :lead].to(k.dtype)
                    v[0, :lead] = vp[cow_src, :lead].to(v.dtype)
                kpg = k[0].reshape(n_pg, PAGE_SIZE, cfg.num_kv_heads,
                                   cfg.head_dim)
                vpg = v[0].reshape(n_pg, PAGE_SIZE, cfg.num_kv_heads,
                                   cfg.head_dim)
                if ring:                             # in place
                    kp[ring_ids] = kpg[ring_src].to(KV_DTYPE)
                    vp[ring_ids] = vpg[ring_src].to(KV_DTYPE)
                else:
                    kp[write_ids] = kpg.to(KV_DTYPE)
                    vp[write_ids] = vpg.to(KV_DTYPE)
                if ctx_ids.numel():
                    # the context pages are strictly earlier than the
                    # chunk's, so the gather sees cached or earlier-chunk
                    # KV only
                    ctx_k = kp[ctx_ids].reshape(1, -1, cfg.num_kv_heads,
                                                cfg.head_dim).to(k.dtype)
                    ctx_v = vp[ctx_ids].reshape(1, -1, cfg.num_kv_heads,
                                                cfg.head_dim).to(v.dtype)
                    k = torch.cat([ctx_k, k], dim=1)
                    v = torch.cat([ctx_v, v], dim=1)
                return attn.sdpa(q, k, v, causal=True, window=window,
                                 q_offset=base)

            x = self._block_forward(bp, x, positions, mix)
        self.prefill_chunks += 1
        return x

    def prefill(self, req: Request) -> None:
        """Forward over the prompt, writing its KV page by page into the
        request's granted pages (global page p holds tokens [p*PAGE,
        (p+1)*PAGE); ring layers keep the prompt's last ``ring_pages``
        pages, page p at ring slot ``p % ring_pages``), and the first
        token.  A stack with sliding-window layers prefills natively; a
        pure-global stack prefills in chunks on the ``chunk_pages`` grid
        (one chunk for a prompt of at most ``chunk_pages`` pages),
        starting past its cached prefix, and then donates its new pages
        to the prefix cache when there is one."""
        if not (req.pages or req.local_pages):
            raise RuntimeError(f"{req.req_id}: prefill before admission")
        if not self.groups.local_layers:
            self._prefill_chunked(req)
            if self.prefix is not None:
                self._prefix_insert(req)
            return
        total_pg = -(-req.prompt_len // PAGE_SIZE)
        if req.pages and len(req.pages) < total_pg:
            raise RuntimeError(f"{req.req_id}: {len(req.pages)} pages < "
                               f"prompt {total_pg}")
        # global ids: the growing table, or the trash page on a pure-local
        # stack (whose table is empty and never read)
        g_ids = (self._phys(req.pages[:total_pg]) if req.pages
                 else [self.trash_page] * total_pg)
        ring_src = ring_ids = None
        if self.use_rings:
            ring = self.groups.ring_pages
            # the last min(ring, total_pg) prompt pages survive, each at
            # ring slot (page % ring): consecutive pages hit distinct slots
            src = list(range(max(0, total_pg - ring), total_pg))
            if len(req.local_pages) < len(src):
                raise RuntimeError(
                    f"{req.req_id}: {len(req.local_pages)} ring pages < "
                    f"the prompt's {len(src)}")
            lp = self._phys_local(req.local_pages)
            ring_src = self._ids(src)
            ring_ids = self._ids([lp[j % ring] for j in src])
        x = self._chunk_forward(self._prompt(req, total_pg), 0,
                                self._ids(g_ids), self._ids([]), ring_ids,
                                ring_src)
        self.prefill_pages_computed += total_pg
        self._first_token(req, x[:, req.prompt_len - 1:req.prompt_len])

    def _prompt(self, req: Request, total_pg: int) -> torch.Tensor:
        """The prompt on the device, zero-padded to ``total_pg`` pages."""
        toks = torch.zeros((1, total_pg * PAGE_SIZE), dtype=torch.long)
        toks[:, :req.prompt_len] = prompt_for(req, self.cfg.vocab_size)
        return toks.to(self.device)

    def _first_token(self, req: Request, x_last: torch.Tensor) -> None:
        logits = self._logits(x_last)[:, -1]
        self._record_margins([req], logits)
        # zenlint-torch: ignore[ZL004] -- the first token: once per request
        # (not per token), and the engine needs its id to seed decode
        self.generated[req.req_id] = [int(logits[0].argmax())]

    def _prefill_chunked(self, req: Request) -> None:
        """Suffix-only prefill in chunks on the absolute grid.  The first
        ``req.cached_len`` prompt tokens are already in cache pages
        (``req.shared_pages`` and a copy-on-write lead); computation
        starts at the cached page boundary and each chunk ends on a
        multiple of ``chunk_pages``, so past the cached region warm and
        cold runs of one prompt see the same chunk boundaries."""
        total_pg = -(-req.prompt_len // PAGE_SIZE)
        cached = req.cached_len
        pages_all = list(req.shared_pages) + self._phys(req.pages)
        if len(pages_all) < total_pg:
            raise RuntimeError(f"{req.req_id}: {len(pages_all)} pages < "
                               f"prompt {total_pg}")
        toks = self._prompt(req, total_pg)
        tr = obs_trace.TRACER
        p = cached // PAGE_SIZE                 # == len(req.shared_pages)
        while p < total_pg:
            n_pg = min(self.chunk_pages - p % self.chunk_pages, total_pg - p)
            s0 = p * PAGE_SIZE
            # only the first chunk can start inside the cached region, and
            # then a partial cached page (cow_src_page) backs its lead
            lead = cached - s0 if s0 < cached else 0
            x = self._chunk_forward(
                toks[:, s0:s0 + n_pg * PAGE_SIZE], s0,
                self._ids(pages_all[p:p + n_pg]), self._ids(pages_all[:p]),
                lead=lead, cow_src=req.cow_src_page)
            self.prefill_pages_computed += n_pg
            if tr is not None:
                tr.instant("request", "prefill_chunk", req.req_id,
                           {"start_page": p, "pages": n_pg, "lead": lead})
            p += n_pg
        if self.prefix is not None and cached % PAGE_SIZE:
            # partial-page hit: the fused lead copy above IS the COW
            self.prefix.stats["cow_copies"] += 1
        last = req.prompt_len - 1 - s0
        self._first_token(req, x[:, last:last + 1])

    # -- prefix-cache lifecycle ----------------------------------------------
    def _host_prompt(self, req: Request) -> Tuple[int, ...]:
        """The request's prompt token ids as a host tuple (the trie key).
        A synthesized prompt is made once and memoized on
        ``req.prompt_tokens``, which also pins it for a re-attach."""
        if req.prompt_tokens is None:
            toks = synth_prompt(req.req_id, req.prompt_len,
                                self.cfg.vocab_size)
            req.prompt_tokens = tuple(int(t) for t in toks[0].tolist())
        return req.prompt_tokens

    def prefix_attach(self, req: Request) -> None:
        """Pre-admission lookup+pin: match the prompt against the trie,
        pin the chain, and record the shared-page layout on the request
        so the pool charges only the private suffix.  The engine calls
        this right before ``try_admit`` and detaches (pool-side) if
        admission fails."""
        if self.prefix is None or req.prefix_nodes is not None:
            return
        m = self.prefix.pin(self._host_prompt(req),
                            max_len=req.prompt_len - 1)
        req.prefix_nodes = m.nodes
        req.shared_pages = list(m.phys_pages)
        req.cached_len = m.cached_len
        req.cow_src_page = m.cow_src
        t = obs_trace.TRACER
        if t is not None:
            t.instant("request", "prefix_pin", req.req_id,
                      {"cached_len": m.cached_len,
                       "shared_pages": len(m.phys_pages),
                       "cow": m.cow_src is not None})

    def _prefix_insert(self, req: Request) -> None:
        """Post-prefill donation: move the prompt's freshly computed full
        pages out of the view's accounting into the cache (the request
        keeps referencing them, now as pinned shared pages), and donate
        the partial tail page after a self-COW (grant a replacement page,
        copy the tail into it on every layer, hand the original to the
        cache).  A race -- another request inserted the same prefix this
        tick -- adopts nothing: ``probe_new`` sizes the donation at 0 and
        this request keeps its private copies."""
        cache = self.prefix
        toks = self._host_prompt(req)
        n_full = req.prompt_len // PAGE_SIZE
        rem = req.prompt_len % PAGE_SIZE
        n_att = len(req.shared_pages)
        pool = self.engine.pool if self.engine is not None else None
        if pool is None or n_att > n_full:
            return
        n_new, partial_new = cache.probe_new(toks, n_att)
        phys: List[int] = []
        if n_new:
            phys = pool.cache_donate(req.pages[:n_new])
            del req.pages[:n_new]
            req.shared_pages.extend(phys)
        partial_phys = None
        if partial_new and rem and n_att + n_new == n_full:
            got = pool.cow_grant()
            if got is not None:
                # after the slice above, the partial tail page is the
                # request's first remaining private page
                self._cow_copy(self._phys(req.pages[:1])[0],
                               self._phys(got)[0])
                partial_phys = pool.cache_donate(req.pages[:1])[0]
                req.pages[0] = got[0]
                cache.stats["cow_copies"] += 1
        if phys or partial_phys is not None:
            created = cache.insert(toks, n_att, phys,
                                   partial_page=partial_phys)
            req.prefix_nodes = (req.prefix_nodes or []) + created
            t = obs_trace.TRACER
            if t is not None:
                t.instant("request", "prefix_insert", req.req_id,
                          {"donated": len(phys),
                           "partial": partial_phys is not None})

    def prefix_reattach(self, req: Request) -> bool:
        """Re-pin the shared prefix chain a drained request was decoding
        through (replica migration).  The pages may have moved (evicted
        and re-inserted by another tenant) but the token chain is the
        key, so any surviving chain of ``parked_shared`` full nodes is
        content-identical.  False: some node was evicted meanwhile, and
        the caller requeues the request for a recompute."""
        if req.parked_shared == 0:
            return True
        if self.prefix is None:
            return False
        m = self.prefix.pin(self._host_prompt(req),
                            max_full=req.parked_shared)
        if len(m.phys_pages) < req.parked_shared:
            self.reattach_unpins += self.prefix.unpin(m.nodes)
            return False
        req.prefix_nodes = m.nodes
        req.shared_pages = list(m.phys_pages)
        return True

    # -- decode --------------------------------------------------------------
    def decode(self, running: List[Request]) -> None:
        """One batched step.  Each layer writes at its group's page (the
        growing table's, or the ring's ``(p // PAGE) % ring_pages``) and
        attends through its group's table: K1 with ``window=
        sliding_window, ring=True`` on ring layers, with the window alone
        on local layers read through the growing table, plain on global
        layers.  Tables and write slots carry physical ids: a request
        with a cached prefix leads its table with the cache's read-only
        pages (already physical) and follows with its view-translated
        private pages; decode always writes past the prefix, so only
        private pages are written."""
        if not running:
            return
        b = self.max_batch
        if len(running) > b:
            raise RuntimeError(f"{len(running)} running > max_batch {b}")
        cfg = self.cfg
        ring = self.groups.ring_pages if self.use_rings else 1
        pos = [r.length for r in running]              # write positions
        for r, p in zip(running, pos):
            if ((r.pages or r.shared_pages)
                    and p // PAGE_SIZE >= len(r.shared_pages) + len(r.pages)):
                raise RuntimeError(
                    f"{r.req_id}: token {p} beyond granted pages "
                    f"({len(r.shared_pages)} shared + {len(r.pages)}) -- "
                    "engine must grow with horizon=1")
            if self.use_rings and (p // PAGE_SIZE) % ring >= len(
                    r.local_pages):
                raise RuntimeError(
                    f"{r.req_id}: token {p} beyond granted ring pages "
                    f"({len(r.local_pages)}/{ring})")
        g_phys = [list(r.shared_pages) + self._phys(r.pages) for r in running]
        l_phys = [self._phys_local(r.local_pages) if self.use_rings else []
                  for r in running]
        s = zensan.SAN
        if s is not None:
            # runtime twin of zenlint ZL001: every id entering the table
            # must be this view's grant or a cache page (host lists: the
            # hook reads nothing from the card)
            s.table(self.engine.pool if self.engine is not None else None,
                    g_phys, l_phys)
        # padded to max_batch: idle lanes write into the trash page with an
        # all -1 table and valid length 1, so they attend to nothing and
        # the kernel writes zeros for them
        maxp_b = _next_pow2(max(max(len(p) for p in g_phys), 1))
        toks = np.zeros((b, 1), np.int64)
        positions = np.zeros((b, 1), np.int64)
        offs = np.zeros(b, np.int64)
        vlen = np.ones(b, np.int32)
        phys_g = np.full(b, self.trash_page, np.int64)
        phys_l = np.full(b, self.trash_page, np.int64)
        table_g = np.full((b, maxp_b), -1, np.int32)
        table_g[:len(running)] = page_table(running, maxp_b, pages=g_phys)
        table_l = np.full((b, ring), -1, np.int32)
        for i, (r, p) in enumerate(zip(running, pos)):
            toks[i, 0] = self.generated[r.req_id][-1]
            positions[i, 0] = p
            offs[i] = p % PAGE_SIZE
            vlen[i] = p + 1
            if g_phys[i]:
                phys_g[i] = g_phys[i][p // PAGE_SIZE]
            if self.use_rings:
                phys_l[i] = l_phys[i][(p // PAGE_SIZE) % ring]
                table_l[i, :len(l_phys[i])] = l_phys[i]
        dev = self.device
        toks_t = torch.from_numpy(toks).to(dev)
        positions_t = torch.from_numpy(positions).to(dev)
        offs_t = torch.from_numpy(offs).to(dev)
        vlen_t = torch.from_numpy(vlen).to(dev)
        phys_g_t = torch.from_numpy(phys_g).to(dev)
        table_g_t = torch.from_numpy(table_g).to(dev)
        if self.use_rings:
            phys_l_t = torch.from_numpy(phys_l).to(dev)
            table_l_t = torch.from_numpy(table_l).to(dev)
        x = embed_tokens(cfg, self.params, toks_t)
        for layer, bp in enumerate(self.layers):
            kp, vp = self.store.k_pages[layer], self.store.v_pages[layer]
            ring_layer = self._layer_ring(layer)
            phys, table = ((phys_l_t, table_l_t) if ring_layer
                           else (phys_g_t, table_g_t))
            window = self._layer_window(layer)

            def mix(q, k, v, kp=kp, vp=vp, phys=phys, table=table,
                    window=window, ring_layer=ring_layer):
                kp[phys, offs_t] = k[:, 0].to(KV_DTYPE)   # in place
                vp[phys, offs_t] = v[:, 0].to(KV_DTYPE)
                return paged_attention(q[:, 0], kp, vp, table, vlen_t,
                                       window=window,
                                       ring=ring_layer)[:, None]

            x = self._block_forward(bp, x, positions_t, mix)
        logits = self._logits(x)[:, -1]
        self._record_margins(running, logits)
        # zenlint-torch: ignore[ZL004] -- the one batched device->host
        # fetch of the step: the engine needs the next tokens' ids
        nxt = logits.argmax(-1).tolist()
        for i, req in enumerate(running):
            self.generated[req.req_id].append(nxt[i])

    # -- parking ---------------------------------------------------------------
    def park(self, drained):
        """Snapshot the weights and ONLY the view's pages: each drained
        request's private KV goes to the host per layer group
        (:meth:`_gather_drained`, then the checkpointer's array format).
        The per-layer views of the weights (``self.layers``) go with the
        weights.  The store's page tensors are dropped only when no
        co-tenant still decodes through them: a PARKED co-tenant does not
        count (its KV is on the host already, and unpark revives the
        tensors), so the last active user of the store to park takes its
        device memory with it; an aliased tenant's reclamation otherwise
        IS its pages returning to the pod's free list."""
        state = super().park(drained)
        self.layers = None
        state["kv"] = tree_to_host(self._gather_drained(drained))
        pool = self.engine.pool if self.engine is not None else None
        own = getattr(pool, "app", None)
        views = getattr(getattr(pool, "shared", None), "views", {})
        sole = all(getattr(views.get(u), "parked", False)
                   for u in self.store.users if u != own)
        if sole:
            # cached prefix pages live inside these tensors: flush them
            # (every pin was dropped when the tenants' requests were
            # reclaimed) so the index does not outlive the content
            shared = getattr(pool, "shared", None)
            if shared is not None:
                shared.flush_prefix_caches(self.store.key)
            elif self.prefix is not None:
                self.prefix.flush()
            self.store.drop_arrays()
        state["arrays_dropped"] = sole
        self._release_device_memory()
        return state

    def unpark(self, state, restored):
        super().unpark(state, restored)
        self.layers = layer_params(self.params, self.cfg)
        self.store.ensure_arrays()      # a no-op when co-tenants kept them
        self._scatter_restored(tree_from_host(state["kv"], self.device),
                               restored)

    # -- replica migration ----------------------------------------------------
    can_migrate = True

    def _layer_split(self) -> Tuple[List[int], List[int]]:
        table_layers = [l for l in range(self.num_layers)
                        if not self._layer_ring(l)]
        ring_layers = [l for l in range(self.num_layers)
                       if self._layer_ring(l)]
        return table_layers, ring_layers

    def _gather_drained(self, drained) -> Dict:
        """Each drained request's private KV, keyed by request: per layer
        group one (layers, n_pages, PAGE, KV, hd) K and V copy on the
        device for the growing tables and one for the rings.  ``drained``
        carries the physical ids ``reclaim`` translated before freeing
        them; the copies are taken before any of them is granted again.
        A migration keeps them on the card; ``park`` takes them to the
        host."""
        table_layers, ring_layers = self._layer_split()

        def gather(layers, ids):
            if not layers or not ids:
                return None
            idx = self._ids(ids)
            return (torch.stack([self.store.k_pages[l][idx] for l in layers]),
                    torch.stack([self.store.v_pages[l][idx] for l in layers]))

        return {req.req_id: {"g": gather(table_layers, g_ids),
                             "l": gather(ring_layers, l_ids)}
                for req, (g_ids, l_ids) in drained}

    def _scatter_restored(self, kv: Dict, restored: List[Request]) -> None:
        """Write gathered KV back at each restored request's CURRENT
        grants, translated through this runner's own pool (the target
        replica's view; the page tensors are the same)."""
        table_layers, ring_layers = self._layer_split()
        for req in restored:
            saved = kv[req.req_id]
            for layers, ids, packed in (
                    (table_layers, self._phys(req.pages), saved["g"]),
                    (ring_layers, self._phys_local(req.local_pages),
                     saved["l"])):
                if packed is None:
                    continue
                k, v = packed
                idx = self._ids(ids)
                for li, layer in enumerate(layers):
                    self.store.k_pages[layer][idx] = k[li]
                    self.store.v_pages[layer][idx] = v[li]

    def migrate_out(self, drained):
        state = super().migrate_out(drained)
        state["kv"] = self._gather_drained(drained)
        return state

    def migrate_in(self, state, restored):
        super().migrate_in(state, restored)
        self._scatter_restored(state["kv"], restored)


def build_runner(backend: str, cfg: ModelConfig, *, seed: int = 0,
                 max_batch: int = 4, cache_len: int = 256,
                 pool_pages: int = 128, use_rings: bool = True,
                 kv_store: Optional[KVArrayStore] = None,
                 prefix_cache=None,
                 chunk_pages: int = 4, params: Optional[dict] = None,
                 device: DeviceLike = None,
                 record_margins: bool = False, layout=None) -> ModelRunner:
    """Factory keyed by the serving backend name.  ``kv_store`` aliases
    the paged backend onto the pod's shared page tensors;
    ``prefix_cache`` attaches a prefix cache, and is refused on the dense
    backend (it has no page identity to share), as the reference refuses
    it, rather than silently dropped.  ``layout`` (a serving plan over a
    mesh) is the dense backend's only."""
    if backend == "dense":
        if prefix_cache is not None:
            raise ValueError(
                "backend='dense' cannot serve prefix_cache=True: the "
                "dense KV cache has no shareable page identity; use "
                "backend='paged' or drop the option")
        return DenseRunner(cfg, seed=seed, max_batch=max_batch,
                           cache_len=cache_len, params=params, device=device,
                           record_margins=record_margins, layout=layout)
    if layout is not None:
        raise NotImplementedError(
            f"backend={backend!r} under a plan of a mesh: the paged backend "
            "on a mesh is ROADMAP item A8d (serve it with backend='dense')")
    if backend == "paged":
        return PagedRunner(cfg, seed=seed, pool_pages=pool_pages,
                           max_batch=max_batch, use_rings=use_rings,
                           kv_store=kv_store, prefix_cache=prefix_cache,
                           chunk_pages=chunk_pages, params=params,
                           device=device, record_margins=record_margins)
    raise ValueError(f"unknown serving backend {backend!r} "
                     "(expected 'dense' or 'paged')")
