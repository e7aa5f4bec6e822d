"""dbrx-132b [moe]: 40L, d_model=6144, 48H (GQA kv=8), d_ff=10752 (per
expert), vocab=100352.  16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]

A copy of ``repro/configs/dbrx_132b.py``.
"""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig, register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10_752,
        vocab_size=100_352,
        pattern=(MOE,),
        moe=MoEConfig(num_experts=16, top_k=4, d_expert=10_752),
        rope_theta=500_000.0,
        max_context=32_768,
    )
