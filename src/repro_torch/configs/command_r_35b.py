"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000,
GQA, no bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab_size=256_000, head_dim=128,
    activation="silu", glu=True, norm="layernorm", qkv_bias=False,
    pos_emb="rope", rope_theta=8e6, tie_embeddings=True,
    fsdp=True, family="dense",
    supports_long_context=False,  # pure full attention
))
