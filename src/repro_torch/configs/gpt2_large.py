"""gpt2-large (paper's own benchmark model): 36L d=1280 20H d_ff=5120
vocab=50257, decoder-only, learned positions. [Radford et al. 2019]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gpt2-large",
    n_layers=36, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=50_257,
    activation="gelu", glu=False, norm="layernorm", qkv_bias=True,
    pos_emb="learned", tie_embeddings=True, family="dense",
    supports_long_context=False,
))
