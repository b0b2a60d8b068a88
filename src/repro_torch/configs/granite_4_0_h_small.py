"""granite-4.0-h-small [hybrid]: 40L d=4096, Mamba-2 (128 heads of 64, state
128) with GQA NoPE attention at layers 5, 15, 25 and 35; every layer a MoE
FFN of 72 experts of 768 (top-10) beside a SiLU-GLU shared expert of 1536;
µP scalars. [hf: ibm-granite/granite-4.0-h-small config.json]

The port's own configuration (not one of the reference's): ``layer_types``
puts attention at position 5 of every period of 10. The mixer's conv has a
bias, the attention logits are scaled by ``attention_multiplier`` (1/128)
in place of 1/sqrt(128), the embedding is multiplied by 12, each residual
branch by 0.22 and the logits divided by 16. A bucket's left pads are no
part of a sequence, so the mixer holds them out of its state
(``ssm_skip_pads``). Norms run at the published eps 1e-5. SSM state has no paged form, so the model serves from the contiguous slot
pool."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-4.0-h-small",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=768,
    vocab_size=100_352, head_dim=128,
    mixer_pattern=("mamba",) * 5 + ("attn",) + ("mamba",) * 4,
    ffn_pattern=("moe",), n_experts=72, top_k=10,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1, conv_width=4,
    ssm_chunk=256, conv_bias=True, ssm_skip_pads=True,
    shared_d_ff=1536, embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, attention_multiplier=0.0078125,
    activation="silu", glu=True, norm="rmsnorm", norm_eps=1e-5,
    pos_emb="none", tie_embeddings=True, max_seq_len=131_072, family="hybrid",
    supports_long_context=True,
))
