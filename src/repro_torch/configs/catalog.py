"""Import the architecture configs the port serves so the registry is populated."""
from . import command_r_35b, gpt2_large, olmo_1b, starcoder2_15b  # noqa: F401

PORTED = ["gpt2-large", "command-r-35b", "olmo-1b", "starcoder2-15b"]
