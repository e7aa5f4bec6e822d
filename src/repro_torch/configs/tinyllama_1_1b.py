"""tinyllama-1.1b [dense]: 22L, d_model=2048, 32H (GQA kv=4), d_ff=5632,
vocab=32000.  llama2-arch small.  [arXiv:2401.02385; hf]

A copy of ``repro/configs/tinyllama_1_1b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("tinyllama-1.1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32_000,
        pattern=(ATTN_GLOBAL,),
        rope_theta=10_000.0,
        max_context=2048,
    )
