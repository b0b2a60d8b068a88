"""repro_torch — the RACE-IT reproduction ported to PyTorch and CUDA.

A package beside the JAX reference `repro`, mirroring its module names.
It imports torch and numpy only: never jax, never anything of `repro`.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    With no card and no explicit request this raises; the port never falls
    back to the CPU by itself.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
