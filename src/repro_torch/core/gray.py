"""Gray-code output encoding (paper Section V-A, Table I).

Encoding the ACAM *output* bits in Gray code halves the number of runs-of-1s
per output bit, which halves the number of stored ranges (= ACAM cells).
The compiler needs the encoder only: tables are evaluated as LUTs.
"""
from __future__ import annotations

__all__ = ["gray_encode"]


def gray_encode(n):
    """Binary code -> Gray code (works on ints, numpy arrays or tensors)."""
    return n ^ (n >> 1)

