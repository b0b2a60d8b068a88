"""Import the architecture configs the port serves so the registry is populated.

``granite-4.0-h-small`` is the port's own configuration: registered, and
in neither of the reference's lists below."""
from . import (bert_base, bert_large, command_r_35b,  # noqa: F401
               gemma3_4b, gpt2_large, granite_4_0_h_small, jamba_v0_1_52b,
               llama4_scout_17b_a16e, mamba2_130m, mixtral_8x22b, olmo_1b,
               qwen2_vl_2b, starcoder2_15b, whisper_tiny)

PORTED = ["gpt2-large", "command-r-35b", "olmo-1b", "starcoder2-15b",
          "gemma3-4b", "mixtral-8x22b", "llama4-scout-17b-a16e",
          "mamba2-130m", "jamba-v0.1-52b", "bert-base", "bert-large",
          "whisper-tiny", "qwen2-vl-2b"]

# the reference's two lists (`repro.configs.catalog`): the assigned grid the
# dry-run covers, and the paper's own models
ASSIGNED = ["llama4-scout-17b-a16e", "mixtral-8x22b", "command-r-35b",
            "gemma3-4b", "starcoder2-15b", "olmo-1b", "mamba2-130m",
            "jamba-v0.1-52b", "qwen2-vl-2b", "whisper-tiny"]
PAPER_OWN = ["bert-base", "bert-large", "gpt2-large"]
