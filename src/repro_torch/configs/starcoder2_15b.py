"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) d_ff=24576 vocab=49152,
GQA + RoPE. [arXiv:2402.19173; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49_152, head_dim=128,
    activation="gelu", glu=False, norm="layernorm", qkv_bias=True,
    pos_emb="rope", rope_theta=1e5,
    fsdp=True, family="dense",
    supports_long_context=False,
))
