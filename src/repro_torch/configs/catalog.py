"""Import the architecture configs the port serves so the registry is populated."""
from . import (command_r_35b, gemma3_4b, gpt2_large, olmo_1b,  # noqa: F401
               starcoder2_15b)

PORTED = ["gpt2-large", "command-r-35b", "olmo-1b", "starcoder2-15b",
          "gemma3-4b"]
