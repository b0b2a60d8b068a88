"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1. [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]

The reference's configuration field for field: 40 heads padded to 48 (the
padded heads are masked to zero), all global attention, so the model serves
block-paged. ``expert_parallel`` only picks the mesh layout of the experts,
which the port does not shard yet."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202_048, head_dim=128,
    head_pad_to=48,  # 40 heads don't divide model=16; pad+mask (see base.py)
    ffn_pattern=("moe",), n_experts=16, top_k=1, expert_parallel=True,
    activation="silu", glu=True, norm="rmsnorm", pos_emb="rope", rope_theta=5e5,
    fsdp=True, family="moe",
    supports_long_context=False,  # full attention; long_500k skipped (DESIGN §5)
))
