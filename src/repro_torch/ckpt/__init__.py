"""Checkpoints of the port (the reference's format) and weights across from
the reference package."""
from .manager import CheckpointManager  # noqa: F401
from .reference import (load_reference_checkpoint,  # noqa: F401
                        load_reference_training_checkpoint,
                        opt_state_from_numpy, params_from_numpy)
