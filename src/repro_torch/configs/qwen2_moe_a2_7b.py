"""qwen2-moe-a2.7b [moe]: 24L, d_model=2048, 16H (GQA kv=16), d_ff=1408
(per expert), vocab=151936.  60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

A copy of ``repro/configs/qwen2_moe_a2_7b.py``.
"""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig, register


@register("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,                    # routed expert hidden
        vocab_size=151_936,
        pattern=(MOE,),
        moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                      num_shared_experts=4, d_shared_expert=5632),
        rope_theta=1_000_000.0,
        max_context=32_768,
        notes="fine-grained experts; 60 padded to 64 for expert-parallel",
    )
