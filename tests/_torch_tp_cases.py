"""Shared cases of the port's tensor- and sequence-parallel training tests
(tests/test_torch_tp_train.py) and of the reference's side of them
(``tests/_torch_sharded_child.py tp_train``).

Each case is a tiny catalog model (`tests/conftest.py` `tiny_config`,
``fsdp`` as the catalog sets it), a few field overrides, a mesh, a batch
shape, a microbatch count and ``cfg.remat``. Weights come from the
reference's ``Model.init(PRNGKey(0))`` (the child saves them with the
gradients); batches from numpy seeds.
"""
import numpy as np

# tag -> (arch, overrides, data, model, B, S, microbatches)
TP_CASES = {
    # the six families at data=2,model=2 (mamba2 at data=1,model=2)
    "gpt2": ("gpt2-large", {}, 2, 2, 4, 16, 1),
    "command_r": ("command-r-35b", {}, 2, 2, 4, 16, 1),
    "gemma3": ("gemma3-4b", {}, 2, 2, 4, 16, 1),
    "mixtral": ("mixtral-8x22b", {}, 2, 2, 4, 16, 1),
    "mamba2": ("mamba2-130m", {}, 1, 2, 2, 16, 1),
    "jamba": ("jamba-v0.1-52b", {}, 2, 2, 4, 16, 1),
    # the encoder-only (bidirectional, unshifted targets), M-RoPE (3, B, S)
    # positions (split on B over the replicas and 2 microbatches) and
    # encoder-decoder (the encoder's sequence split, cross attention) kinds
    "bert": ("bert-base", {}, 2, 2, 4, 16, 1),
    "qwen2_vl": ("qwen2-vl-2b", {}, 2, 2, 8, 16, 2),
    "whisper": ("whisper-tiny", {}, 2, 2, 4, 16, 1),
    # data replicas only: one model position each
    "data_only": ("command-r-35b", {}, 2, 1, 4, 16, 1),
    # the drop cases: KV heads (2) not dividing model=4, a sequence (15)
    # not dividing 2, an odd vocab (255), and the SSD chunk axis (3 heads)
    "kv_drop": ("command-r-35b", {}, 1, 4, 2, 16, 1),
    "seq_drop": ("command-r-35b", {}, 2, 2, 4, 15, 1),
    "vocab_drop": ("gpt2-large", {"vocab_size": 255}, 2, 2, 4, 16, 1),
    "ssm_chunks": ("mamba2-130m", {"d_model": 48, "ssm_headdim": 32}, 1, 2,
                   2, 16, 1),
    # two microbatches, and remat on ("dots": the weight products kept;
    # "full": every layer recomputed)
    "micro": ("command-r-35b", {}, 2, 2, 8, 16, 2),
    "remat_dots": ("mixtral-8x22b", {"remat": "dots",
                                     "expert_parallel": True}, 2, 2, 4, 16,
                   1),
    "remat_full": ("gpt2-large", {"remat": "full"}, 2, 2, 4, 16, 1),
}


def tp_config(tag):
    """The reference's config of a case (remat off unless the case sets
    it; it changes no number)."""
    from repro.configs import get_config
    from conftest import tiny_config
    arch, over = TP_CASES[tag][:2]
    return tiny_config(get_config(arch)).replace(**{"remat": "none", **over})


def tp_batch(tag, cfg):
    """The case's numpy batch: tokens and a loss mask dropping about a
    third of the positions; frame embeddings for an encoder-decoder, and
    (3, B, S) positions whose three channels differ for M-RoPE."""
    B, S = TP_CASES[tag][4:6]
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32),
             "loss_mask": (rng.random((B, S)) > 0.33).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_feats"] = rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.pos_emb == "mrope":
        batch["positions"] = rng.integers(0, 4 * S, (3, B, S)
                                          ).astype(np.int32)
    return batch
