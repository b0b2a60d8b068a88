"""olmo-1b [dense]: 16L d=2048 16H (MHA kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=50_304,
    activation="silu", glu=True, norm="np_layernorm",  # no learnable scale/bias
    pos_emb="rope", rope_theta=1e4, tie_embeddings=True,
    family="dense", supports_long_context=False,
))
