"""mamba2-130m [ssm]: 24L d=768 attention-free, vocab=50280, ssm_state=128,
SSD (state-space duality). [arXiv:2405.21060; unverified]

The reference's configuration field for field: every layer is a Mamba-2
mixer with no FFN, so the model has no KV cache and no paged cache form; it
serves from the contiguous slot pool."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280,
    mixer_pattern=("mamba",), ffn_pattern=("none",),
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1, conv_width=4,
    ssm_chunk=128,  # L^2 intra-chunk term: H=24 cannot shard over model=16
    norm="rmsnorm", pos_emb="none", tie_embeddings=True,
    family="ssm", supports_long_context=True,  # O(1) decode state
))
