"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336, MoE 16e top-2,
Mamba:attention 7:1 interleave. [arXiv:2403.19887; hf]

The reference's configuration field for field: a period of 8 layers, one
global attention layer (position 4) and seven Mamba-2 mixers, a dense FFN
and a MoE FFN in turn; SSM state has no paged form, so the model serves
from the contiguous slot pool. ``expert_parallel`` and ``fsdp`` are carried
and have no effect at tensor-parallel size 1."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65_536, head_dim=128,
    # one attention layer per 8 (position 4), mamba elsewhere; MoE every 2nd.
    mixer_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe"),
    n_experts=16, top_k=2, expert_parallel=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1,
    activation="silu", glu=True, norm="rmsnorm", pos_emb="none",  # jamba: no RoPE
    fsdp=True, family="hybrid",
    supports_long_context=True,  # 28/32 layers are O(1)-state mamba
))
