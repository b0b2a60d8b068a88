"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

The names of `repro.kernels`, less its interpret-mode switches: a wrapper
here runs its CUDA kernel on a CUDA tensor and its plain version on a CPU
tensor. ``acam_lut`` and ``acam_mvm`` name both a module and, as in the
reference, the function the module holds: calling the module calls it.
"""
import types

from . import acam_lut, acam_mvm
from .ops import (  # noqa: F401
    FUSED_SOFTMAX_MODES, acam_activation, acam_attention_codes,
    acam_attention_decode_codes, acam_lut_2d, acam_softmax_codes,
    acam_softmax_kernel, masked_prefix_quantize, prob_requant_scale,
    raceit_attention_decode_fused, raceit_attention_fused, raceit_linear,
)


class _FunctionModule(types.ModuleType):
    def __call__(self, *args, **kw):
        return getattr(self, self.__name__.rsplit(".", 1)[1])(*args, **kw)


acam_lut.__class__ = _FunctionModule
acam_mvm.__class__ = _FunctionModule

__all__ = ["FUSED_SOFTMAX_MODES", "acam_activation", "acam_attention_codes",
           "acam_attention_decode_codes", "acam_lut", "acam_lut_2d",
           "acam_mvm", "acam_softmax_codes", "acam_softmax_kernel",
           "masked_prefix_quantize", "prob_requant_scale",
           "raceit_attention_decode_fused", "raceit_attention_fused",
           "raceit_linear"]
