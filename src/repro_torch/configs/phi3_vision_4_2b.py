"""phi-3-vision-4.2b [vlm]: 32L, d_model=3072, 32H (GQA kv=32), d_ff=8192,
vocab=32064.  phi3-mini backbone + CLIP vision frontend (STUB: input_specs
provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

A copy of ``repro/configs/phi3_vision_4_2b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("phi-3-vision-4.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32_064,
        pattern=(ATTN_GLOBAL,),
        num_image_tokens=576,         # stubbed CLIP patch embeddings
        rope_theta=10_000.0,
        max_context=131_072,
        notes="vision frontend stubbed; image tokens prepended to sequence",
    )
