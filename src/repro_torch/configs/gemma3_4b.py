"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global attention, 128k context. [hf:google/gemma-3; unverified]

The reference's configuration field for field; it sets no head_dim, so the
head dim resolves to d_model / n_heads = 320."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab_size=262_144,
    mixer_pattern=("attn_local",) * 5 + ("attn",), window=1024,  # 5:1 local:global
    activation="gelu", glu=True, norm="rmsnorm", pos_emb="rope", rope_theta=1e6,
    tie_embeddings=True, family="dense",
    supports_long_context=True,  # 5/6 of layers have bounded-window KV
))
