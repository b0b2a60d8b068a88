"""bert-base (paper's own benchmark model): 12L d=768 12H d_ff=3072
vocab=30522, encoder-only. [arXiv:1810.04805]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="bert-base",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=30_522,
    causal=False, activation="gelu", glu=False, norm="layernorm",
    qkv_bias=True, pos_emb="learned", family="encoder",
    supports_long_context=False,
))
