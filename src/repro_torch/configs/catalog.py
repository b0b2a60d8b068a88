"""Import the architecture configs the port serves so the registry is populated."""
from . import (command_r_35b, gemma3_4b, gpt2_large,  # noqa: F401
               jamba_v0_1_52b, llama4_scout_17b_a16e, mamba2_130m,
               mixtral_8x22b, olmo_1b, starcoder2_15b)

PORTED = ["gpt2-large", "command-r-35b", "olmo-1b", "starcoder2-15b",
          "gemma3-4b", "mixtral-8x22b", "llama4-scout-17b-a16e",
          "mamba2-130m", "jamba-v0.1-52b"]
