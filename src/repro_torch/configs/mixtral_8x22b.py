"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]

The reference's configuration field for field: every layer is a
sliding-window (``attn_local``, window 4096) attention layer with a MoE FFN,
so the model serves from the contiguous slot pool (ring caches have no
paged form)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32_768, head_dim=128,
    mixer_pattern=("attn_local",), window=4096,  # SWA per assignment
    ffn_pattern=("moe",), n_experts=8, top_k=2,
    activation="silu", glu=True, norm="rmsnorm", pos_emb="rope", rope_theta=1e6,
    fsdp=True, family="moe",
    supports_long_context=True,  # SWA => sub-quadratic, bounded KV
))
