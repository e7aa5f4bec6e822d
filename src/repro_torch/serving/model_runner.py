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

Where the reference donates its page arrays to ``jit`` so XLA updates them
in place, the port writes the page tensors in place (``index_put_``).

:class:`DenseRunner` keeps a preallocated per-slot dense cache of
``cache_len`` tokens (KV laid out (B, KV, S, hd); Mamba-2 and RWKV-6
states) and drives ``Model.prefill`` and ``Model.decode_step``, which
write into it in place.  It serves global-attention, Mamba-2, RWKV-6 and
zamba2's hybrid stacks through the flash-attention forward (prefill),
the decode-attention kernel, the SSD and WKV scan kernels, and RMSNorm.
It copies the reference's behaviour exactly, since token parity depends
on it: prompts are never padded, and decode runs the whole slot batch at
one shared position.  A sliding-window layer's dense cache is a ring of
``min(cache_len, window)`` slots.

Both serve from a private pool.  The prefix cache (queue item A3), a
pod-shared ``KVArrayStore``, park/unpark and replica migration (A6) come
with later slices: asking for them raises ``ValueError``.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.model import (Model, check_family, embed_tokens,
                                      init_params, layer_params)
from repro_torch.models.transformer import ImplConfig
from repro_torch.serving.kv_cache import (PAGE_SIZE, PageGroups, Request,
                                         page_table)

KV_DTYPE = torch.bfloat16


class KVArrayStore:
    """The page tensors of one runner: per layer one K and one V tensor of
    ``(pool_pages + 1, PAGE_SIZE, KV, hd)``, the last page being trash.
    A ring layer's tensors are indexed by the pool's local (ring) ids, a
    global layer's by its global ids: both id spaces are ``[0,
    pool_pages)``.  (The reference's store is also the aliasing unit of
    pod-shared tenants; the port's is private until that slice.)"""

    def __init__(self, num_layers: int, pool_pages: int, kv_heads: int,
                 head_dim: int, device: torch.device, dtype=KV_DTYPE):
        self.page_shape = (pool_pages + 1, PAGE_SIZE, kv_heads, head_dim)
        self.k_pages = [torch.zeros(self.page_shape, dtype=dtype,
                                    device=device)
                        for _ in range(num_layers)]
        self.v_pages = [torch.zeros(self.page_shape, dtype=dtype,
                                    device=device)
                        for _ in range(num_layers)]

    def device_bytes(self) -> int:
        """Bytes of the page tensors (the stats view's gauge)."""
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


class ModelRunner:
    """Backend interface the engine's step functions are bound to."""

    backend = "null"

    def __init__(self, record_margins: bool = False):
        self.engine = None
        self.generated: Dict[str, List[int]] = {}
        # parity checks: the top-1 minus top-2 logit gap of every emitted
        # token, per request (a near-tie may flip under other roundings)
        self.margins: Optional[Dict[str, List[float]]] = (
            {} if record_margins else None)

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

    def _record_margins(self, reqs: List[Request], logits: torch.Tensor):
        """logits: one (V,) row per request in ``reqs``."""
        if self.margins is None:
            return
        top = logits.topk(2, dim=-1).values
        for req, gap in zip(reqs, (top[:, 0] - top[:, 1]).tolist()):
            self.margins.setdefault(req.req_id, []).append(gap)


class DenseRunner(ModelRunner):
    """Slot-indexed dense cache; prefill through ``Model.prefill`` and
    decode through ``Model.decode_step`` (the reference's
    ``DenseRunner``)."""

    backend = "dense"

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 max_batch: int = 4, cache_len: int = 256,
                 params: Optional[dict] = None, device: DeviceLike = None,
                 record_margins: bool = False):
        super().__init__(record_margins)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.model = Model(cfg, ImplConfig(remat="none"))
        # first: it refuses the kinds the dense path does not serve yet
        # before any weight is made
        self.cache = self.model.init_cache(max_batch, cache_len, self.device)
        self.params = (init_params(cfg, seed, self.device) if params is None
                       else params)
        self.slots: Dict[str, tuple] = {}      # req_id -> (slot, prompt_len)

    def prefill(self, req: Request) -> None:
        """Forward over the whole prompt -- never padded or bucketed: the
        recurrent state after padded tokens cannot be masked back out --
        writing its decode state into the request's slot."""
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
        logits, _ = self.model.prefill(self.params, toks, self.cache_len,
                                       cache=self.cache, slot=slot)
        self._record_margins([req], logits[:, -1])
        self.generated[req.req_id] = [int(logits[0, -1].argmax())]

    def decode(self, running: List[Request]) -> None:
        """One step for the whole slot batch at ONE shared position, the
        largest ``prompt_len + generated`` of the running requests, as the
        reference does: every lane's KV is written at that slot and every
        lane attends over ``[0, pos]`` (a shorter request's cache holds
        zero K/V rows in between, which take part in its softmax), and
        RWKV-6's sinusoidal position is that ``pos`` too.  Idle slots run
        token 0; their state is overwritten by the next prefill."""
        if not running:
            return
        toks = np.zeros((self.max_batch, 1), np.int64)
        pos = 0
        for req in running:
            slot, plen = self.slots[req.req_id]
            toks[slot, 0] = self.generated[req.req_id][-1]
            pos = max(pos, plen + req.generated)
        logits, _ = self.model.decode_step(
            self.params, torch.from_numpy(toks).to(self.device), self.cache,
            pos)
        slots = [self.slots[r.req_id][0] for r in running]
        self._record_margins(running, logits[slots, -1])
        # the one batched device->host fetch of the step
        nxt = logits[:, -1].argmax(-1).tolist()
        for req, slot in zip(running, slots):
            self.generated[req.req_id].append(nxt[slot])

    def finish(self, req: Request) -> None:
        super().finish(req)
        self.slots.pop(req.req_id, None)


class PagedRunner(ModelRunner):
    """KV in pool pages; prefill through the flash-attention kernel and
    decode through the paged-attention kernel.  Global layers keep a
    growing page table; with ``use_rings`` sliding-window layers keep a
    fixed ring of ``PageGroups.ring_pages`` pages a request (without, they
    read the growing table through the window mask)."""

    backend = "paged"

    SUPPORTED_KINDS = (ATTN_GLOBAL, ATTN_LOCAL)

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 pool_pages: int = 128, max_batch: int = 4,
                 use_rings: bool = True, prefix_cache=None,
                 chunk_pages: int = 4, params: Optional[dict] = None,
                 device: DeviceLike = None, record_margins: bool = False):
        super().__init__(record_margins)
        if cfg.rope_theta <= 0:
            raise ValueError(f"backend='paged' needs RoPE; {cfg.name} has "
                             f"rope_theta={cfg.rope_theta}")
        check_family(cfg)
        if any(k not in self.SUPPORTED_KINDS for k in cfg.pattern):
            raise ValueError(
                f"backend='paged' serves RoPE global/sliding-window "
                f"attention stacks; {cfg.name} has pattern={cfg.pattern} "
                "(serve it with backend='dense')")
        if ATTN_LOCAL in cfg.pattern and cfg.sliding_window <= 0:
            raise ValueError(f"{cfg.name}: ATTN_LOCAL needs sliding_window")
        if prefix_cache is not None:
            raise ValueError("the prefix cache comes with queue item A3 of "
                             "the port")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.groups = PageGroups.from_config(cfg)
        self.use_rings = use_rings and self.groups.local_layers > 0
        self.chunk_pages = max(int(chunk_pages), 1)
        self.params = (init_params(cfg, seed, self.device) if params is None
                       else params)
        self.layers = layer_params(self.params, cfg)
        self.num_layers = cfg.num_layers
        self.pool_pages = pool_pages
        self.trash_page = pool_pages            # padded lanes write here
        self.store = KVArrayStore(self.num_layers, pool_pages,
                                  cfg.num_kv_heads, cfg.head_dim, self.device)
        # forwards over prompt chunks (a native prefill is one chunk)
        self.prefill_chunks = 0

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _layer_kind(self, layer: int) -> str:
        return self.cfg.pattern[layer % len(self.cfg.pattern)]

    def _layer_ring(self, layer: int) -> bool:
        """Whether this layer's table is a ring (vs a growing table)."""
        return self.use_rings and self._layer_kind(layer) == ATTN_LOCAL

    def _layer_window(self, layer: int) -> int:
        return (self.cfg.sliding_window
                if self._layer_kind(layer) == ATTN_LOCAL else 0)

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
                       ring_src: Optional[torch.Tensor] = None):
        """Forward over one page-aligned chunk of prompt tokens starting at
        absolute position ``base``: scatter its KV into ``write_ids``
        pages and attend over the ``ctx_ids`` pages (the prompt's earlier
        pages, none for a native prefill) plus the chunk itself.  Ring
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
                    # chunk's, so the gather sees earlier-chunk KV only
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
        pages, page p at ring slot ``p % ring_pages``).  A pure-global
        stack prefills prompts longer than ``chunk_pages`` pages in chunks
        that end on multiples of ``chunk_pages``, as the reference's
        chunked path; a stack with sliding-window layers always prefills
        natively."""
        if not (req.pages or req.local_pages):
            raise RuntimeError(f"{req.req_id}: prefill before admission")
        total_pg = -(-req.prompt_len // PAGE_SIZE)
        if req.pages and len(req.pages) < total_pg:
            raise RuntimeError(f"{req.req_id}: {len(req.pages)} pages < "
                               f"prompt {total_pg}")
        toks = torch.zeros((1, total_pg * PAGE_SIZE), dtype=torch.long)
        toks[:, :req.prompt_len] = prompt_for(req, self.cfg.vocab_size)
        toks = toks.to(self.device)
        if self.groups.local_layers:
            # global ids: the growing table, or the trash page on a
            # pure-local stack (whose table is empty and never read)
            g_ids = (req.pages[:total_pg] if req.pages
                     else [self.trash_page] * total_pg)
            ring_src = ring_ids = None
            if self.use_rings:
                ring = self.groups.ring_pages
                # the last min(ring, total_pg) prompt pages survive, each
                # at ring slot (page % ring): consecutive pages hit
                # distinct slots
                src = list(range(max(0, total_pg - ring), total_pg))
                if len(req.local_pages) < len(src):
                    raise RuntimeError(
                        f"{req.req_id}: {len(req.local_pages)} ring pages "
                        f"< the prompt's {len(src)}")
                ring_src = self._ids(src)
                ring_ids = self._ids([req.local_pages[j % ring]
                                      for j in src])
            x = self._chunk_forward(toks, 0, self._ids(g_ids),
                                    self._ids([]), ring_ids, ring_src)
            s0 = 0
        else:
            n_native = total_pg if total_pg <= self.chunk_pages else 0
            p = 0
            while p < total_pg:
                n_pg = n_native or min(self.chunk_pages - p % self.chunk_pages,
                                       total_pg - p)
                s0 = p * PAGE_SIZE
                x = self._chunk_forward(toks[:, s0:s0 + n_pg * PAGE_SIZE], s0,
                                        self._ids(req.pages[p:p + n_pg]),
                                        self._ids(req.pages[:p]))
                p += n_pg
        last = req.prompt_len - 1 - s0
        logits = self._logits(x[:, last:last + 1])[:, -1]
        self._record_margins([req], logits)
        self.generated[req.req_id] = [int(logits[0].argmax())]

    # -- decode --------------------------------------------------------------
    def decode(self, running: List[Request]) -> None:
        """One batched step.  Each layer writes at its group's page (the
        growing table's, or the ring's ``(p // PAGE) % ring_pages``) and
        attends through its group's table: K1 with ``window=
        sliding_window, ring=True`` on ring layers, with the window alone
        on local layers read through the growing table, plain on global
        layers."""
        if not running:
            return
        b = self.max_batch
        if len(running) > b:
            raise RuntimeError(f"{len(running)} running > max_batch {b}")
        cfg = self.cfg
        ring = self.groups.ring_pages if self.use_rings else 1
        pos = [r.length for r in running]              # write positions
        for r, p in zip(running, pos):
            if r.pages and p // PAGE_SIZE >= len(r.pages):
                raise RuntimeError(
                    f"{r.req_id}: token {p} beyond granted pages "
                    f"({len(r.pages)}) -- engine must grow with horizon=1")
            if self.use_rings and (p // PAGE_SIZE) % ring >= len(
                    r.local_pages):
                raise RuntimeError(
                    f"{r.req_id}: token {p} beyond granted ring pages "
                    f"({len(r.local_pages)}/{ring})")
        # padded to max_batch: idle lanes write into the trash page with an
        # all -1 table and valid length 1, so they attend to nothing and
        # the kernel writes zeros for them
        maxp_b = _next_pow2(max(max(len(r.pages) for r in running), 1))
        toks = np.zeros((b, 1), np.int64)
        positions = np.zeros((b, 1), np.int64)
        offs = np.zeros(b, np.int64)
        vlen = np.ones(b, np.int32)
        phys_g = np.full(b, self.trash_page, np.int64)
        phys_l = np.full(b, self.trash_page, np.int64)
        table_g = np.full((b, maxp_b), -1, np.int32)
        table_g[:len(running)] = page_table(running, maxp_b)
        table_l = np.full((b, ring), -1, np.int32)
        for i, (r, p) in enumerate(zip(running, pos)):
            toks[i, 0] = self.generated[r.req_id][-1]
            positions[i, 0] = p
            offs[i] = p % PAGE_SIZE
            vlen[i] = p + 1
            if r.pages:
                phys_g[i] = r.pages[p // PAGE_SIZE]
            if self.use_rings:
                phys_l[i] = r.local_pages[(p // PAGE_SIZE) % ring]
                table_l[i, :len(r.local_pages)] = r.local_pages
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
        # the one batched device->host fetch of the step
        nxt = logits.argmax(-1).tolist()
        for i, req in enumerate(running):
            self.generated[req.req_id].append(nxt[i])


def build_runner(backend: str, cfg: ModelConfig, *, seed: int = 0,
                 max_batch: int = 4, cache_len: int = 256,
                 pool_pages: int = 128, use_rings: bool = True,
                 prefix_cache=None,
                 chunk_pages: int = 4, params: Optional[dict] = None,
                 device: DeviceLike = None,
                 record_margins: bool = False) -> ModelRunner:
    """Factory keyed by the serving backend name.  ``prefix_cache`` is
    refused on the dense backend (it has no page identity to share), as
    the reference refuses it, rather than silently dropped."""
    if backend == "dense":
        if prefix_cache is not None:
            raise ValueError(
                "backend='dense' cannot serve prefix_cache=True: the "
                "dense KV cache has no shareable page identity; use "
                "backend='paged' or drop the option")
        return DenseRunner(cfg, seed=seed, max_batch=max_batch,
                           cache_len=cache_len, params=params, device=device,
                           record_margins=record_margins)
    if backend == "paged":
        return PagedRunner(cfg, seed=seed, pool_pages=pool_pages,
                           max_batch=max_batch, use_rings=use_rings,
                           prefix_cache=prefix_cache,
                           chunk_pages=chunk_pages, params=params,
                           device=device, record_margins=record_margins)
    raise ValueError(f"unknown serving backend {backend!r} "
                     "(expected 'dense' or 'paged')")
