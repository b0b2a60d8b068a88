"""Plain oracles for the kernels, over the ported core (the ground truth in
the tests): the port of `repro.kernels.ref`."""
from __future__ import annotations

import torch

from ..core import ops as acam_ops
from ..core.crossbar import CrossbarConfig, bit_sliced_matmul
from ..core.ops import LOGIT_FMT
from ..core.softmax import acam_softmax as _core_acam_softmax

__all__ = ["lut_ref", "mvm_ref", "mvm_exact_ref", "softmax_codes_ref",
           "softmax_ref"]


def lut_ref(x: torch.Tensor, lut: torch.Tensor, bias: int = 128
            ) -> torch.Tensor:
    """Oracle for kernels.acam_lut: plain gather."""
    return lut.to(torch.int32)[x.long() + bias]


def mvm_ref(x: torch.Tensor, w: torch.Tensor,
            cfg: CrossbarConfig = CrossbarConfig()) -> torch.Tensor:
    """Oracle for kernels.acam_mvm: core.crossbar bit-sliced matmul."""
    return bit_sliced_matmul(x.to(torch.int32), w.to(torch.int32), cfg)


def mvm_exact_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.double() @ w.double()).to(torch.int32)


def softmax_codes_ref(x_codes: torch.Tensor, mode: str = "pot"
                      ) -> torch.Tensor:
    """Oracle for kernels.acam_softmax: the core Fig.-8 dataflow on codes."""
    prob_op = acam_ops.get_op("exp_prob")
    x = LOGIT_FMT.decode(x_codes)
    p = _core_acam_softmax(x, axis=-1, mode=mode)
    return prob_op.out_fmt.encode(p)


def softmax_ref(x: torch.Tensor, mode: str = "pot") -> torch.Tensor:
    return _core_acam_softmax(x, axis=-1, mode=mode)
