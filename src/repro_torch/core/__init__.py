"""Compute-ACAM numerics: formats, the table compiler, the operator library
(the port of `repro.core`, with the same package-level names)."""
from .quant import (  # noqa: F401
    FixedPointFormat, ScaledFormat, PoTFormat, QuantizedTensor,
    quantize_tensor, dequantize_tensor, fake_quant,
)
from .gray import gray_encode, gray_decode, gray_decode_bits  # noqa: F401
from .compiler import (  # noqa: F401
    compile_1var, compile_2var, build_table_1var, build_table_2var,
    eval_range_program, eval_rect_program, array_cost,
    RangeProgram, RectProgram, ArrayCost,
)
from .acam import AcamFunction, Acam2VarFunction, RangeArrays, RectArrays  # noqa: F401
from .ops import get_op, mult4_programs, mult8_codes, OPS  # noqa: F401
from .crossbar import CrossbarConfig, bit_sliced_matmul, crossbar_linear  # noqa: F401
from .softmax import acam_softmax, softmax_reference  # noqa: F401
from .attention import raceit_attention, dd_matmul_codes  # noqa: F401
