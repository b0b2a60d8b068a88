"""Meshes of the port and the card's roofline constants.

The port of `repro.launch.mesh`. Functions, never module-level meshes, so
importing this module touches no device.

`make_production_mesh` is the dry-run's target, sized for the card rather
than the reference's TPU v5e pod (16 x 16 chips): 256 H100s, 8 to an
NVLink node, with the ``model`` axis inside a node (tensor parallelism
stays on NVLink) and the ``data`` (and ``pod``) axes across nodes over
InfiniBand. Single: ``data 32 x model 8``; multi: ``pod 2 x data 32 x
model 8``. It is a `MeshSpec` built over device-free positions (every
position on ``meta``), so it allocates nothing and needs no card.

The constants are NVIDIA's datasheet figures for the H100 SXM5 80GB at
700 W, not measurements: a card set below 700 W runs slower.
"""
from __future__ import annotations

from ..dist import MeshSpec

__all__ = ["make_host_mesh", "make_production_mesh", "PEAK_BF16_FLOPS",
           "PEAK_INT8_OPS", "HBM_BW", "HBM_BYTES", "NVLINK_BW", "IB_BW",
           "AXIS_BW"]

# H100 SXM5 80GB, 700 W: NVIDIA datasheet figures, not measurements
PEAK_BF16_FLOPS = 989e12     # dense BF16 tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12      # dense int8 tensor-core op/s
HBM_BW = 3.35e12             # HBM3 B/s
NVLINK_BW = 450e9            # NVLink 4, B/s per direction per GPU
IB_BW = 50e9                 # InfiniBand NDR 400 Gb/s, B/s per GPU
HBM_BYTES = 80e9             # HBM capacity

# the link each mesh axis crosses: model inside a node, data and pod across
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}


def make_production_mesh(*, multi_pod: bool = False):
    """256 H100s as ``data 32 x model 8`` (``multi_pod``: two such pods,
    ``pod 2 x data 32 x model 8``), every position on ``meta``."""
    axes = ((("pod", 2),) if multi_pod else ()) + (("data", 32),
                                                   ("model", 8))
    spec = MeshSpec(axes=axes)
    return spec.build(["meta"] * spec.n_devices)


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                   devices=None, kind: str = "cuda"):
    """A (pod,) data x model mesh over ``devices`` (see `MeshSpec.build`:
    none given, ``cuda:0 .. n-1`` or every position on the CPU)."""
    axes = ((("pod", pod),) if pod else ()) + (("data", data),
                                               ("model", model))
    return MeshSpec(axes=axes).build(devices, kind=kind)
