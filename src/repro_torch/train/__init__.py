"""Training of the port (port of repro.train): AdamW, the train step, the
fault-tolerant loop."""
from . import optim, trainer  # noqa: F401
from .loop import TrainLoopConfig, run_training  # noqa: F401
