"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, dynamic resolution; vision frontend is a stub (precomputed patch
embeddings via input_specs). [arXiv:2409.12191; hf]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151_936, head_dim=128,
    activation="silu", glu=True, norm="rmsnorm", qkv_bias=True,
    pos_emb="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    tie_embeddings=True, frontend="vision_stub",
    family="vlm", supports_long_context=False,
))
