"""Adaptive materialization: resource graph -> physical execution plan.

The port's copy of ``repro/core/materializer.py``: the whole ``MeshSpec``,
``Plan``, ``estimate_bytes_per_device``, the locality ladder
(``materialize``), overrides and compile-feedback ``escalate``.  The
ladder is host arithmetic over the analytic profiles, so it gives the
reference's plans and byte estimates exactly for any mesh it is handed;
the port's mesh registry holds one card (``H100``) and four cards of one
host (``H100X4``).

The paper adapts, per invocation, which components co-locate vs. get
placed remotely, component sizes from profiled history, and local- vs.
remote-memory versions.  On an accelerator mesh:

  server            -> device        (fast local HBM)
  co-located data   -> replicated weights / unsharded activations
  remote data       -> sharded weights (TP/FSDP): every access becomes a
                       collective
  user-level swap   -> remat / microbatching / host offload
  component sizing  -> per-invocation remat depth, microbatch, KV layout

The *locality ladder* below is the paper's greedy placement policy
(§5.1.1): try the most-local materialization first, escalate to
progressively more "remote" (sharded / recomputed / offloaded) placements
only when the proactive per-device memory estimate (profiles + history)
exceeds the HBM budget.  A measured footprint over the budget (the
port's counterpart of the reference's ``compiled.memory_analysis()`` is
``torch.cuda.max_memory_allocated``) feeds ``escalate``, which moves one
rung up (reactive auto-scaling, §5.1.2).  The ``TorchExecutor`` binds a
training plan of a multi-device mesh inside a ``torch.distributed``
world of that many ranks, and refuses one outside it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import profiles as prof
from repro_torch.core.history import HistoryStore

GB = 1 << 30


# NVIDIA H100 80GB HBM3 (SXM, 700 W), from the spec sheet: 80e9 bytes of
# HBM, 989e12 dense bf16 tensor-core FLOP/s, 3.35e12 B/s of HBM
# bandwidth, 900e9 B/s of NVLink per device
H100_HBM_BYTES = 80_000_000_000
H100_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 900e9


@dataclass(frozen=True)
class MeshSpec:
    """Mesh description (decoupled from device state); the defaults are
    one H100's figures."""
    name: str
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    hbm_per_device: int = H100_HBM_BYTES
    peak_flops: float = H100_BF16_FLOPS    # bf16 / device
    hbm_bw: float = H100_HBM_BW            # bytes/s
    ici_bw: float = H100_NVLINK_BW         # bytes/s/device (NVLink)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)] if name in self.axes else 1

    @property
    def batch_capable_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a != "model")


#: one card
H100 = MeshSpec("h100", (1, 1), ("data", "model"))
#: four cards of one host, all to all over NVLink, as a (2, 2) mesh: a
#: training plan binds on it through ``torch.distributed``, one rank a card
H100X4 = MeshSpec("h100x4", (2, 2), ("data", "model"))

MESHES = {m.name: m for m in (H100, H100X4)}


@dataclass
class Plan:
    """Physical materialization of one invocation class."""
    arch: str
    shape: str
    mesh: MeshSpec
    batch_axes: Tuple[str, ...] = ()
    seq_axes: Tuple[str, ...] = ()          # sequence / KV-seq sharding
    tp: bool = True                         # model axis does tensor parallel
    ep: bool = False                        # experts over model axis
    fsdp: bool = False                      # params sharded over data
    zero: bool = True                       # optimizer state sharded
    remat: str = "none"
    microbatch: int = 1
    attn_impl: str = "naive"
    kv_shard_heads: bool = False
    kv_shard_seq: bool = False
    offload_optimizer: bool = False
    grad_compression: Optional[str] = None  # e.g. "int8" on the pod axis
    loss_chunk: int = 0                     # chunked-CE streaming (0 = off)
    moe_dispatch: str = "psum"              # psum | a2a
    scan_chunk: int = 128                   # rwkv/ssd chunk length
    # FSDP dim choice: False = prefer non-contraction dims (H1; best terms);
    # True = legacy largest-dim (lower residency on some stacks: gemma3)
    fsdp_contracting: bool = False
    est_bytes_per_device: int = 0
    notes: List[str] = field(default_factory=list)

    def log(self, msg: str):
        self.notes.append(msg)

    @property
    def dp_degree(self) -> int:
        d = 1
        for a in self.batch_axes:
            d *= self.mesh.axis_size(a)
        return d

    def describe(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh.name,
            "batch_axes": self.batch_axes, "seq_axes": self.seq_axes,
            "tp": self.tp, "ep": self.ep, "fsdp": self.fsdp,
            "zero": self.zero, "remat": self.remat,
            "microbatch": self.microbatch, "attn_impl": self.attn_impl,
            "kv_shard_heads": self.kv_shard_heads,
            "kv_shard_seq": self.kv_shard_seq,
            "offload_optimizer": self.offload_optimizer,
            "grad_compression": self.grad_compression,
            "loss_chunk": self.loss_chunk,
            "moe_dispatch": self.moe_dispatch,
            "scan_chunk": self.scan_chunk,
            "fsdp_contracting": self.fsdp_contracting,
            "est_bytes_per_device": self.est_bytes_per_device,
            "notes": self.notes,
        }


# ---------------------------------------------------------------------------
# Proactive per-device byte estimation under a candidate plan
# ---------------------------------------------------------------------------

def estimate_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                              plan: Plan) -> int:
    mesh = plan.mesh
    tp_deg = mesh.axis_size("model") if plan.tp else 1
    dp_deg = max(plan.dp_degree, 1)
    data_deg = mesh.axis_size("data")

    pbytes = prof.param_bytes(cfg)
    p_dev = pbytes / tp_deg
    if plan.fsdp:
        p_dev /= data_deg

    if shape.kind == "train":
        obytes = prof.optimizer_bytes(cfg) / tp_deg
        if plan.zero or plan.fsdp:
            obytes /= data_deg
        if plan.offload_optimizer:
            obytes = 0
        grads = pbytes / tp_deg / (data_deg if plan.fsdp else 1)
        act = prof.activation_bytes_train(
            cfg, shape, plan.remat, plan.microbatch, plan.attn_impl)
        act_dev = act / dp_deg / tp_deg  # logits/attn shard over tp as well
        return int(p_dev + obytes + grads + act_dev)

    kv = prof.kv_cache_bytes(cfg, shape)
    kv_deg = dp_deg
    if plan.kv_shard_heads or plan.kv_shard_seq:
        kv_deg *= mesh.axis_size("model")
    if plan.seq_axes:
        d = 1
        for a in plan.seq_axes:
            d *= mesh.axis_size(a)
        kv_deg = max(kv_deg, d * dp_deg)
    act = shape.global_batch * max(shape.seq_len if shape.kind == "prefill"
                                   else 1, 1) * cfg.d_model * prof.BF16 * 8
    return int(p_dev + kv / max(kv_deg, 1) + act / max(dp_deg * tp_deg, 1))


# ---------------------------------------------------------------------------
# The locality ladder
# ---------------------------------------------------------------------------

def _pick_batch_axes(shape: ShapeConfig, mesh: MeshSpec,
                     include_model: bool) -> Tuple[str, ...]:
    """Largest prefix of (batch-capable [+ model]) axes dividing the batch."""
    axes = list(mesh.batch_capable_axes)
    if include_model:
        axes.append("model")
    chosen: List[str] = []
    degree = 1
    b = shape.global_batch
    for a in axes:
        s = mesh.axis_size(a)
        if b % (degree * s) == 0:
            chosen.append(a)
            degree *= s
    return tuple(chosen)


def materialize(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, *,
                history: Optional[HistoryStore] = None,
                overrides: Optional[Dict] = None) -> Plan:
    """Proactive materialization: profiles (+ history) -> Plan."""
    plan = Plan(cfg.name, shape.name, mesh)
    budget = int(mesh.hbm_per_device * 0.92)

    # ---- history refinement: prefer measured bytes when available --------
    if history is not None:
        measured = history.peak(cfg.name, f"{shape.name}/{mesh.name}",
                                "bytes_per_device", 0.0)
        if measured:
            plan.log(f"history: measured peak {measured/GB:.2f} GiB/device "
                     "available; proactive sizing will be cross-checked")

    # ---- rung 0: structural choices ---------------------------------------
    # "all-local": pure data parallelism (params replicated, zero TP
    # collectives inside a step) -- feasible only if the batch covers the
    # whole mesh and the replicated state fits.
    all_local_axes = _pick_batch_axes(shape, mesh, include_model=True)
    all_local_deg = 1
    for a in all_local_axes:
        all_local_deg *= mesh.axis_size(a)

    if shape.kind != "train":
        _materialize_inference(cfg, shape, mesh, plan, budget)
        return _apply_overrides(plan, overrides, cfg, shape, budget)

    if "model" in all_local_axes and all_local_deg == mesh.num_devices:
        cand = dataclasses.replace(
            plan, tp=False, batch_axes=all_local_axes, zero=True)
        cand.notes = list(plan.notes)
        est = estimate_bytes_per_device(cfg, shape, cand)
        if est <= budget:
            cand.log(f"rung0: all-local DP({all_local_deg}) fits "
                     f"({est/GB:.2f} GiB <= {budget/GB:.2f} GiB)")
            cand.est_bytes_per_device = est
            plan = cand
        else:
            plan.log(f"rung0: all-local DP estimate {est/GB:.2f} GiB "
                     "exceeds budget; falling back to TP")
            plan.batch_axes = _pick_batch_axes(shape, mesh, False)
    else:
        plan.batch_axes = _pick_batch_axes(shape, mesh, False)
        plan.log(f"rung0: batch axes {plan.batch_axes} "
                 f"(global_batch={shape.global_batch}); model axis -> TP")

    if plan.tp and cfg.moe is not None:
        plan.ep = True
        plan.moe_dispatch = "a2a"
        plan.log("rung0: MoE arch -> expert parallelism over model axis "
                 "(a2a token exchange; measured 2.5x MFU-UB vs psum combine, "
                 "see EXPERIMENTS §Perf)")

    # long sequences force memory-bounded attention regardless of rung
    if shape.seq_len >= 8192 and not cfg.is_attention_free:
        plan.attn_impl = "chunked"
        plan.log("rung0: seq>=8k -> chunked (flash) attention")

    # ---- rungs 1..n: escalate until the proactive estimate fits -----------
    if plan.tp:
        # microbatch must keep the per-microbatch batch divisible by DP
        max_mb = max(shape.global_batch // max(plan.dp_degree, 1), 1)

        def mb_rung(m):
            return (f"microbatch={m}",
                    lambda p: dataclasses.replace(p, microbatch=m))

        rungs = [
            ("zero", lambda p: dataclasses.replace(p, zero=True)),
            ("remat=dots", lambda p: dataclasses.replace(p, remat="dots")),
            ("remat=full", lambda p: dataclasses.replace(p, remat="full")),
            ("fsdp", lambda p: dataclasses.replace(p, fsdp=True)),
        ]
        rungs += [mb_rung(m) for m in (2, 4) if m <= max_mb]
        rungs.append(("attn=chunked", lambda p: dataclasses.replace(
            p, attn_impl="chunked")))
        rungs += [mb_rung(m) for m in (8, 16) if m <= max_mb]
        # host offload of optimizer state is opt-in only (overrides), as
        # in the reference

        est = estimate_bytes_per_device(cfg, shape, plan)
        for name, fn in rungs:
            if est <= budget:
                break
            notes = plan.notes
            plan = fn(plan)
            plan.notes = notes
            est = estimate_bytes_per_device(cfg, shape, plan)
            plan.log(f"ladder: +{name} -> est {est/GB:.2f} GiB/device")
        plan.est_bytes_per_device = int(est)
        if est > budget:
            plan.log("ladder exhausted: estimate still over budget; "
                     "compile feedback will decide")

    # cross-pod gradient sync is the slow link: compression stays opt-in
    if "pod" in mesh.axes and shape.kind == "train":
        plan.grad_compression = None  # opt-in via overrides (beyond-paper)

    return _apply_overrides(plan, overrides, cfg, shape, budget)


def _materialize_inference(cfg: ModelConfig, shape: ShapeConfig,
                           mesh: MeshSpec, plan: Plan, budget: int) -> None:
    plan.batch_axes = _pick_batch_axes(shape, mesh, include_model=False)
    plan.zero = False
    plan.remat = "none"
    tp_size = mesh.axis_size("model")
    if cfg.moe is not None:
        plan.ep = True
    if shape.kind == "prefill":
        plan.attn_impl = "chunked" if shape.seq_len >= 8192 else "naive"
    # KV placement: heads over model axis when divisible, else sequence
    if cfg.num_kv_heads % tp_size == 0:
        plan.kv_shard_heads = True
        plan.log(f"kv: heads({cfg.num_kv_heads}) shard over model({tp_size})")
    else:
        plan.kv_shard_seq = True
        plan.log(f"kv: heads({cfg.num_kv_heads}) !% model({tp_size}); "
                 "sequence-sharded KV (flash-decode combine)")
    # batch=1 long-context: spread the sequence over every idle axis
    if shape.global_batch < mesh.axis_size("data"):
        leftover = tuple(a for a in mesh.batch_capable_axes
                         if a not in plan.batch_axes)
        plan.seq_axes = leftover + (("model",) if plan.kv_shard_seq else ())
        plan.log(f"long-context: seq axes {plan.seq_axes}")
    # weight-gathered serving: if TP-sharded params alone crowd the HBM,
    # shard them over the data axis too (all-gather per layer in the scan)
    p_dev = prof.param_bytes(cfg) / tp_size
    if p_dev > 0.5 * budget:
        plan.fsdp = True
        plan.log(f"params {p_dev/GB:.1f} GiB/device at TP{tp_size}: "
                 "weight-gathered serving (shard over data axis)")
    plan.est_bytes_per_device = estimate_bytes_per_device(cfg, shape, plan)
    plan.log(f"inference est {plan.est_bytes_per_device/GB:.2f} GiB/device")


def _apply_overrides(plan: Plan, overrides: Optional[Dict],
                     cfg: ModelConfig, shape: ShapeConfig,
                     budget: int) -> Plan:
    if overrides:
        notes = plan.notes
        plan = dataclasses.replace(plan, **overrides)
        plan.notes = notes
        plan.log(f"overrides applied: {overrides}")
        plan.est_bytes_per_device = estimate_bytes_per_device(cfg, shape, plan)
    return plan


def escalate(plan: Plan, cfg: ModelConfig, shape: ShapeConfig,
             measured_bytes: int) -> Optional[Plan]:
    """Compile-feedback escalation (reactive auto-scaling, §5.1.2).

    Called when the measured footprint exceeds the HBM budget even though
    the proactive estimate fit.  Returns the next plan up the ladder,
    or None if exhausted."""
    budget = int(plan.mesh.hbm_per_device * 0.92)
    order: List[Tuple[str, Dict]] = []
    if not plan.tp:
        order.append(("enable TP", {"tp": True}))
    if plan.remat == "none":
        order.append(("remat=dots", {"remat": "dots"}))
    elif plan.remat == "dots":
        order.append(("remat=full", {"remat": "full"}))
    if not plan.zero and shape.kind == "train":
        order.append(("zero", {"zero": True}))
    if not plan.fsdp:
        # for inference this is weight-gathered serving: params shard over
        # the data axis and are all-gathered per layer inside the scan
        order.append(("fsdp", {"fsdp": True}))
    if plan.attn_impl == "naive" and not cfg.is_attention_free:
        order.append(("attn=chunked", {"attn_impl": "chunked"}))
    max_mb = max(shape.global_batch // max(plan.dp_degree, 1), 1)
    if plan.microbatch * 2 <= max_mb and shape.kind == "train":
        order.append((f"microbatch={plan.microbatch*2}",
                      {"microbatch": plan.microbatch * 2}))
    if plan.fsdp and not plan.fsdp_contracting:
        # last resort: switch the FSDP layout family -- some stacks
        # (gemma3) have lower residency under the legacy contraction-dim
        # sharding even though its roofline terms are worse
        order.append(("fsdp_contracting", {"fsdp_contracting": True}))
    if not order:
        return None
    name, kw = order[0]
    notes = list(plan.notes)
    new = dataclasses.replace(plan, **kw)
    new.notes = notes
    new.log(f"compile-feedback: measured {measured_bytes/GB:.2f} GiB > "
            f"budget {budget/GB:.2f} GiB -> {name}")
    return new
