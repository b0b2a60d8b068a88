"""bert-large (paper's own benchmark model): 24L d=1024 16H d_ff=4096
vocab=30522, encoder-only. [arXiv:1810.04805]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="bert-large",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=30_522,
    causal=False, activation="gelu", glu=False, norm="layernorm",
    qkv_bias=True, pos_emb="learned", family="encoder",
    supports_long_context=False,
))
