"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H (kv=8), d_ff=2048,
vocab=51865.  Encoder-decoder; conv audio frontend is a STUB (input_specs
provides precomputed 1500-frame embeddings).  [arXiv:2212.04356; unverified]

A copy of ``repro/configs/whisper_base.py``.
"""
from repro_torch.configs.base import DEC_ATTN, ModelConfig, register


@register("whisper-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        num_layers=6,                 # decoder layers (assignment: 6L)
        num_encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51_865,
        pattern=(DEC_ATTN,),
        encoder_seq_len=1_500,        # 30 s audio -> 1500 frames post-conv
        rope_theta=0.0,               # whisper uses learned/sinusoidal pos
        tie_embeddings=True,
        max_context=448,
        notes="enc-dec; conv frontend stubbed as precomputed frame embeddings",
    )
