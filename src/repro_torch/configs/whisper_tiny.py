"""whisper-tiny [audio]: 4L d=384 6H (MHA kv=6) d_ff=1536 vocab=51865,
encoder-decoder; conv audio frontend is a stub (precomputed frame embeddings
via input_specs). [arXiv:2212.04356; unverified]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51_865,
    is_encoder_decoder=True, n_encoder_layers=4, encoder_len=1500,
    activation="gelu", glu=False, norm="layernorm", qkv_bias=True,
    pos_emb="learned", tie_embeddings=True, frontend="audio_stub",
    family="audio", supports_long_context=False,
))
