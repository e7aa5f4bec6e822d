"""rwkv6-7b [ssm]: 32L, d_model=4096, attention-free, d_ff=14336,
vocab=65536.  RWKV-6 "Finch" with data-dependent decay.  [arXiv:2404.05892; hf]

A copy of ``repro/configs/rwkv6_7b.py``.
"""
from repro_torch.configs.base import RWKV6, ModelConfig, SSMConfig, register


@register("rwkv6-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,                 # rwkv6 heads = d_model / 64
        num_kv_heads=64,
        head_dim=64,
        d_ff=14_336,
        vocab_size=65_536,
        pattern=(RWKV6,),
        ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=128),
        rope_theta=0.0,
        max_context=1 << 30,          # state-based: unbounded context
        notes="Finch: data-dependent decay w_t; constant-size recurrent state",
    )
