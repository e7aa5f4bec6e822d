"""zamba2-2.7b [hybrid]: 54L, d_model=2560, 32H (GQA kv=32), d_ff=10240,
ssm_state=64.  Mamba2 backbone + weight-SHARED attention blocks.
[arXiv:2411.15242; hf]

A copy of ``repro/configs/zamba2_2_7b.py``.  The shared attention block is
one set of weights applied at nine depths (``params["shared_attn"]``);
each application keeps only its input norm (``ln_in``) of its own.
"""
from repro_torch.configs.base import (ATTN_SHARED, MAMBA2, ModelConfig,
                                      SSMConfig, register)


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10_240,
        vocab_size=32_000,
        pattern=(MAMBA2,) * 5 + (ATTN_SHARED,),
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=128),
        rope_theta=10_000.0,
        max_context=4096,
        notes="9 pattern blocks of 5 mamba2 + 1 shared-weight attention",
    )
