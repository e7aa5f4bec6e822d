"""Resource graph: the paper's intermediate representation.  A copy of
``repro/core/graph.py`` over the port's spec trees.

Nodes are *compute components* (code sites with distinctive FLOPs/parallelism
profiles) and *data components* (memory objects with distinctive
size/lifetime profiles).  Edges are ``triggers`` (compute -> compute) and
``accesses`` (compute -> data).

Compute components are the model's pattern-block groups plus
embed/head/loss/optimizer; data components are parameter groups, optimizer
state, activations, KV caches and MoE dispatch buffers.  Weight sharing
(zamba2's shared attention) appears as one data component accessed by many
compute components -- exactly the paper's Figure 6 structure.

The graph carries proactive resource profiles (analytic, refined by history)
that the materializer uses for placement; the failure-recovery *cut*
semantics (§5.3.2) are defined over this graph as well.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.configs.base import (ATTN_SHARED, MOE, ModelConfig,
                                      ShapeConfig)
from repro_torch.core import profiles as prof


@dataclass
class ComputeComponent:
    name: str
    kind: str                       # pattern kind | embed | head | optimizer
    flops: int                      # per invocation (global)
    parallelism: int                # max usable parallel units (tokens)
    count: int = 1                  # scanned repetitions (num_blocks)
    annotation: str = "@compute"


@dataclass
class DataComponent:
    name: str
    bytes: int                      # global bytes
    lifetime: str                   # step | persistent | transient
    input_dependent: bool = False   # size varies with invocation input
    annotation: str = "@data"


@dataclass
class Edge:
    src: str
    dst: str
    kind: str                       # triggers | accesses
    bytes: int = 0                  # data volume along the edge


@dataclass
class ResourceGraph:
    arch: str
    shape: str
    compute: Dict[str, ComputeComponent] = field(default_factory=dict)
    data: Dict[str, DataComponent] = field(default_factory=dict)
    edges: List[Edge] = field(default_factory=list)

    def add_compute(self, c: ComputeComponent):
        self.compute[c.name] = c

    def add_data(self, d: DataComponent):
        self.data[d.name] = d

    def connect(self, src: str, dst: str, kind: str, nbytes: int = 0):
        self.edges.append(Edge(src, dst, kind, nbytes))

    # -- queries used by the materializer / scheduler ----------------------
    def total_flops(self) -> int:
        return sum(c.flops * c.count for c in self.compute.values())

    def total_bytes(self, lifetimes=("step", "persistent")) -> int:
        return sum(d.bytes for d in self.data.values()
                   if d.lifetime in lifetimes)

    def accessors(self, data_name: str) -> List[str]:
        return [e.src for e in self.edges
                if e.kind == "accesses" and e.dst == data_name]

    def shared_data(self) -> List[str]:
        """Data components accessed by more than one compute component."""
        return [d for d in self.data if len(set(self.accessors(d))) > 1]

    def cut_boundaries(self) -> List[str]:
        """Compute components whose completion defines a recoverable cut:
        every edge crossing the boundary is persistently recordable."""
        # On the training substrate a cut is the optimizer update (a full
        # step); for serving it is each completed request batch.
        return [n for n, c in self.compute.items()
                if c.kind in ("optimizer", "head")]

    def topo_order(self) -> List[str]:
        """Trigger-edge topological order of compute components."""
        indeg = {n: 0 for n in self.compute}
        adj: Dict[str, List[str]] = {n: [] for n in self.compute}
        for e in self.edges:
            if e.kind == "triggers" and e.src in indeg and e.dst in indeg:
                adj[e.src].append(e.dst)
                indeg[e.dst] += 1
        order, q = [], [n for n, d in indeg.items() if d == 0]
        while q:
            n = q.pop(0)
            order.append(n)
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    q.append(m)
        return order


def build_resource_graph(cfg: ModelConfig, shape: ShapeConfig
                         ) -> ResourceGraph:
    """Decompose one invocation class into the paper's IR."""
    g = ResourceGraph(cfg.name, shape.name)
    is_train = shape.kind == "train"
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 3 if is_train else 1

    # ---- embedding -------------------------------------------------------
    embed_bytes = cfg.vocab_size * cfg.d_model * prof.BF16
    g.add_data(DataComponent("w_embed", embed_bytes, "persistent"))
    g.add_compute(ComputeComponent(
        "embed", "embed", 2 * tokens * cfg.d_model * mult, tokens))
    g.connect("embed", "w_embed", "accesses", embed_bytes)

    # ---- pattern blocks ----------------------------------------------------
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    prev = "embed"
    for i, kind in enumerate(cfg.pattern):
        cname = f"block_p{i}_{kind}"
        flops = prof.block_fwd_flops_per_token(
            cfg, kind, shape.seq_len, causal=not shape.is_decode) * tokens * mult
        g.add_compute(ComputeComponent(cname, kind, flops, tokens,
                                       count=cfg.num_blocks))
        g.connect(prev, cname, "triggers", tokens * cfg.d_model * prof.BF16)
        if kind == ATTN_SHARED:
            if "w_shared_attn" not in g.data:
                sb = L.param_bytes(T.block_specs(cfg, kind))  # tiny ln only
                shared = T.shared_specs(cfg).get("shared_attn", {})
                sb += L.param_bytes(shared)
                g.add_data(DataComponent("w_shared_attn", sb, "persistent"))
            g.connect(cname, "w_shared_attn", "accesses")
        else:
            wb = L.param_bytes(T.block_specs(cfg, kind)) * cfg.num_blocks
            g.add_data(DataComponent(f"w_{cname}", wb, "persistent"))
            g.connect(cname, f"w_{cname}", "accesses", wb)
        if kind == MOE:
            # all-to-all dispatch buffer: transient, input-dependent
            cap_bytes = int(tokens * cfg.moe.top_k * cfg.moe.capacity_factor
                            * cfg.d_model * prof.BF16)
            g.add_data(DataComponent(f"dispatch_{i}", cap_bytes, "transient",
                                     input_dependent=True))
            g.connect(cname, f"dispatch_{i}", "accesses", cap_bytes)
        prev = cname

    # ---- head / loss -------------------------------------------------------
    head_flops = 2 * tokens * cfg.d_model * cfg.vocab_size * mult
    g.add_compute(ComputeComponent("head", "head", head_flops, tokens))
    g.connect(prev, "head", "triggers", tokens * cfg.d_model * prof.BF16)
    if not cfg.tie_embeddings:
        hb = cfg.d_model * cfg.vocab_size * prof.BF16
        g.add_data(DataComponent("w_head", hb, "persistent"))
        g.connect("head", "w_head", "accesses", hb)
    else:
        g.connect("head", "w_embed", "accesses", embed_bytes)

    # ---- step-scoped data components ---------------------------------------
    if is_train:
        g.add_data(DataComponent("activations",
                                 prof.activation_bytes_train(cfg, shape),
                                 "step", input_dependent=True))
        g.add_data(DataComponent("optimizer_state",
                                 prof.optimizer_bytes(cfg), "persistent"))
        g.add_compute(ComputeComponent(
            "optimizer", "optimizer", 10 * prof.model_param_count(cfg),
            prof.model_param_count(cfg)))
        g.connect("head", "optimizer", "triggers")
        g.connect("optimizer", "optimizer_state", "accesses",
                  prof.optimizer_bytes(cfg))
        for n, c in list(g.compute.items()):
            if n not in ("optimizer",):
                g.connect(n, "activations", "accesses")
    else:
        kvb = prof.kv_cache_bytes(cfg, shape)
        g.add_data(DataComponent("kv_cache", kvb, "persistent",
                                 input_dependent=True))
        for i, kind in enumerate(cfg.pattern):
            g.connect(f"block_p{i}_{kind}", "kv_cache", "accesses")
    return g
