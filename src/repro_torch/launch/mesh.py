"""Small meshes for tests and examples.

The port of `repro.launch.mesh`'s `make_host_mesh`. A function, never a
module-level constant, so importing this module touches no device.
"""
from __future__ import annotations

from ..dist import MeshSpec

__all__ = ["make_host_mesh"]


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                   devices=None, kind: str = "cuda"):
    """A (pod,) data x model mesh over ``devices`` (see `MeshSpec.build`:
    none given, ``cuda:0 .. n-1`` or every position on the CPU)."""
    axes = ((("pod", pod),) if pod else ()) + (("data", data),
                                               ("model", model))
    return MeshSpec(axes=axes).build(devices, kind=kind)
