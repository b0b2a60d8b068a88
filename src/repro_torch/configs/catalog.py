"""Import the architecture configs the port serves so the registry is populated."""
from . import command_r_35b, gpt2_large  # noqa: F401

PORTED = ["gpt2-large", "command-r-35b"]
