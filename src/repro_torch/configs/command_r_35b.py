"""command-r-35b [dense]: 40L, d_model=8192, 64H (GQA kv=8), d_ff=22528,
vocab=256000.  GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]

A copy of ``repro/configs/command_r_35b.py``.  About 30.3 B parameters,
~60.6 GB in bf16: one H100 holds the weights but not a serving pool
beside them at this width, so it is served reduced; its full-width plan
is host arithmetic (``core/materializer.py``).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("command-r-35b")
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22_528,
        vocab_size=256_000,
        pattern=(ATTN_GLOBAL,),
        rope_theta=8_000_000.0,
        tie_embeddings=True,
        max_context=131_072,
        notes="no biases anywhere; parallel attention+FFN residual stream",
    )
