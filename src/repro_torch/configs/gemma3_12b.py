"""gemma3-12b [dense]: 48L, d_model=3840, 16H (GQA kv=8), d_ff=15360,
vocab=262144.  5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

A copy of ``repro/configs/gemma3_12b.py``.  ``scale_embed=True`` stands
for the reference's name test (``cfg.name.startswith("gemma")`` in its
``Model._embed``): token embeddings are multiplied by ``sqrt(d_model)``.
The sliding-window (``ATTN_LOCAL``) layers keep a ring of
``ceil(1024 / 128) + 1 = 9`` pages a request on the paged backend and a
1024-slot ring on the dense one.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ModelConfig,
                                      register)


@register("gemma3-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,                 # gemma3 uses wide heads (16*256=4096)
        d_ff=15_360,
        vocab_size=262_144,
        pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
        sliding_window=1024,
        use_qk_norm=True,
        logit_softcap=0.0,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        scale_embed=True,
        max_context=131_072,
        notes="5:1 local:global; long_500k runs (bounded KV on 5/6 layers)",
    )
