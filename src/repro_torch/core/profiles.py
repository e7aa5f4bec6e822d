"""Resource profiles: analytic FLOPs / bytes per component and per step.
A copy of ``repro/core/profiles.py`` over the port's parameter spec tree
(``models/model.py::param_specs``), which has the reference's layout, so
every count and byte figure equals the reference's.

This is the offline-profiler analog of the paper: every resource-graph node
carries a resource feature (CPU usage -> FLOPs; allocation size/lifetime ->
bytes) that the materializer uses for *proactive* placement and sizing
decisions before anything is built or executed.  Measured footprints are
folded back through the HistoryStore (sample-based profiling), refining
these estimates for future invocations.
"""

from __future__ import annotations

import dataclasses


from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_SHARED,
                                      DEC_ATTN, ENC_ATTN, MAMBA2, MOE, RWKV6,
                                      ModelConfig, ShapeConfig)

BF16 = 2
FP32 = 4


# ---------------------------------------------------------------------------
# Parameter counts
# ---------------------------------------------------------------------------

def padded_num_experts(num_experts: int, multiple: int = 16) -> int:
    """Experts padded so the expert axis shards over the model axis (the
    reference's ``models/moe.py`` helper; the port's MoE family comes with
    a later slice)."""
    return ((num_experts + multiple - 1) // multiple) * multiple


def model_param_count(cfg: ModelConfig) -> int:
    from repro_torch.models.layers import param_count
    from repro_torch.models.model import param_specs
    return param_count(param_specs(cfg))


def model_active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top-k routed + shared only)."""
    total = model_param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    e_pad = padded_num_experts(m.num_experts)
    routed_per_layer = 3 * e_pad * cfg.d_model * m.d_expert
    n_moe_layers = sum(1 for k in cfg.pattern if k == MOE) * cfg.num_blocks
    active_per_layer = 3 * m.top_k * cfg.d_model * m.d_expert
    return total - n_moe_layers * (routed_per_layer - active_per_layer)


def param_bytes(cfg: ModelConfig, bytes_per_param: int = BF16) -> int:
    return model_param_count(cfg) * bytes_per_param


def optimizer_bytes(cfg: ModelConfig) -> int:
    """AdamW: fp32 m + v (+ fp32 master copy)."""
    n = model_param_count(cfg)
    return n * (FP32 + FP32 + FP32)


# ---------------------------------------------------------------------------
# Per-block analytic FLOPs (forward, per token)
# ---------------------------------------------------------------------------

def _attn_proj_flops(cfg: ModelConfig) -> int:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return 2 * d * (h * hd + 2 * kv * hd + h * hd)  # q,k,v,o


def _attn_score_flops(cfg: ModelConfig, kv_len: int) -> int:
    return 2 * 2 * cfg.num_heads * cfg.head_dim * kv_len  # scores + out


def _mlp_flops(cfg: ModelConfig, gated: bool = True) -> int:
    mult = 3 if gated else 2
    return 2 * mult * cfg.d_model * cfg.d_ff


def block_fwd_flops_per_token(cfg: ModelConfig, kind: str, seq_len: int,
                              causal: bool = True) -> int:
    """Forward FLOPs per token for one pattern-block entry."""
    kv_len = seq_len / 2 if causal else seq_len  # average causal footprint
    d = cfg.d_model
    if kind in (ATTN_GLOBAL, ENC_ATTN, ATTN_SHARED):
        return (_attn_proj_flops(cfg) + _attn_score_flops(cfg, int(kv_len))
                + _mlp_flops(cfg, gated=kind != ENC_ATTN))
    if kind == ATTN_LOCAL:
        w = min(cfg.sliding_window, seq_len)
        return (_attn_proj_flops(cfg) + _attn_score_flops(cfg, w)
                + _mlp_flops(cfg))
    if kind == DEC_ATTN:
        cross = _attn_score_flops(cfg, cfg.encoder_seq_len)
        return (2 * _attn_proj_flops(cfg) + _attn_score_flops(cfg, int(kv_len))
                + cross + _mlp_flops(cfg, gated=False))
    if kind == MOE:
        m = cfg.moe
        routed = 2 * 3 * m.top_k * d * m.d_expert
        shared = 2 * 3 * d * m.d_shared_expert if m.num_shared_experts else 0
        router = 2 * d * m.num_experts
        return (_attn_proj_flops(cfg) + _attn_score_flops(cfg, int(kv_len))
                + routed + shared + router)
    if kind == RWKV6:
        proj = 2 * 5 * d * d + 2 * d * d          # r,k,v,g,o + cr
        wkv = 2 * 2 * cfg.num_heads * cfg.head_dim * cfg.head_dim
        cmix = 2 * (d * cfg.d_ff * 2)
        lora = 2 * d * 64 * 2
        return proj + wkv + cmix + lora
    if kind == MAMBA2:
        from repro_torch.models.mamba2 import mamba_dims
        d_inner, h, p_dim, n = mamba_dims(cfg)
        proj = 2 * d * (2 * d_inner + 2 * n + h) + 2 * d_inner * d
        ssd = 2 * 2 * h * p_dim * n               # state update + readout
        chunk = cfg.ssm.chunk_size
        intra = 2 * 2 * chunk * (n + p_dim) / 2   # intra-chunk attn-like
        return int(proj + ssd + intra * h / max(h, 1) * h)
    raise ValueError(kind)


def step_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """MODEL_FLOPS per assignment: 6*N*T (train) / 2*N*T (fwd), N active."""
    n = model_active_param_count(cfg)
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens


def step_hlo_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Analytic estimate of compiled FLOPs (incl. attention quadratics)."""
    if shape.is_decode:
        tokens = shape.global_batch
        per_tok = sum(block_fwd_flops_per_token(cfg, k, shape.seq_len,
                                                causal=False)
                      for k in cfg.pattern) * cfg.num_blocks
    else:
        tokens = shape.global_batch * shape.seq_len
        per_tok = sum(block_fwd_flops_per_token(cfg, k, shape.seq_len)
                      for k in cfg.pattern) * cfg.num_blocks
    head = 2 * cfg.d_model * cfg.vocab_size
    mult = 3 if shape.kind == "train" else 1
    return int(tokens * (per_tok * mult + head * (mult if shape.kind ==
                                                  "train" else 1)))


# ---------------------------------------------------------------------------
# Memory footprints (per step, global bytes)
# ---------------------------------------------------------------------------

def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Global KV-cache / recurrent-state bytes for decode shapes."""
    if not shape.is_decode and shape.kind != "prefill":
        return 0
    b, s = shape.global_batch, shape.seq_len
    total = 0
    for kind in cfg.pattern:
        if kind in (ATTN_GLOBAL, MOE, ATTN_SHARED, DEC_ATTN):
            total += 2 * b * s * cfg.kv_dim * BF16
            if kind == DEC_ATTN:
                total += 2 * b * cfg.encoder_seq_len * cfg.kv_dim * BF16
        elif kind == ATTN_LOCAL:
            w = min(cfg.sliding_window, s)
            total += 2 * b * w * cfg.kv_dim * BF16
        elif kind == RWKV6:
            total += b * cfg.num_heads * cfg.head_dim ** 2 * FP32
            total += 2 * b * cfg.d_model * BF16
        elif kind == MAMBA2:
            from repro_torch.models.mamba2 import mamba_dims
            d_inner, h, p_dim, n = mamba_dims(cfg)
            total += b * h * p_dim * n * FP32
            total += b * (cfg.ssm.conv_width - 1) * (d_inner + 2 * n) * BF16
    return total * cfg.num_blocks


def activation_bytes_train(cfg: ModelConfig, shape: ShapeConfig,
                           remat: str = "full", microbatch: int = 1,
                           attn_impl: str = "naive") -> int:
    """Global activation residency during a train step (analytic)."""
    b = shape.global_batch // microbatch
    s = shape.seq_len
    t = b * s
    d = cfg.d_model
    n_layers = cfg.num_layers
    if remat == "full":
        # saved: per-block input (+ scan carries)
        per_layer = t * d * BF16
    elif remat == "dots":
        per_layer = t * d * BF16 * 6
    else:
        per_layer = t * d * BF16 * 14
    act = n_layers * per_layer
    # attention score tile residency (transient, bounded by impl)
    if attn_impl == "naive":
        act += b * cfg.num_heads * s * s * BF16
    else:
        act += b * cfg.num_heads * 1024 * s * BF16
    # logits + unembed fp32
    act += t * cfg.vocab_size * FP32 // max(1, 1)
    return act


@dataclasses.dataclass
class StepProfile:
    """One invocation class's proactive resource profile."""
    model_flops: int
    hlo_flops_est: int
    param_bytes: int
    optimizer_bytes: int
    kv_bytes: int
    activation_bytes: int

    @property
    def total_state_bytes(self) -> int:
        return (self.param_bytes + self.optimizer_bytes + self.kv_bytes
                + self.activation_bytes)


def step_profile(cfg: ModelConfig, shape: ShapeConfig, *,
                 remat: str = "full", microbatch: int = 1,
                 attn_impl: str = "naive") -> StepProfile:
    is_train = shape.kind == "train"
    return StepProfile(
        model_flops=step_model_flops(cfg, shape),
        hlo_flops_est=step_hlo_flops_estimate(cfg, shape),
        param_bytes=param_bytes(cfg),
        optimizer_bytes=optimizer_bytes(cfg) if is_train else 0,
        kv_bytes=kv_cache_bytes(cfg, shape),
        activation_bytes=(activation_bytes_train(cfg, shape, remat,
                                                 microbatch, attn_impl)
                          if not shape.is_decode else
                          shape.global_batch * cfg.d_model * BF16 * 4),
    )
