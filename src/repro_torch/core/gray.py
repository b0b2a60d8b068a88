"""Gray-code output encoding (paper Section V-A, Table I).

Encoding the ACAM *output* bits in Gray code halves the number of runs-of-1s
per output bit, which halves the number of stored ranges (= ACAM cells).
The binary result is recovered with an XOR prefix over the higher-order bits
(`gray_decode`), as the match-line emulation does.
"""
from __future__ import annotations

__all__ = ["gray_encode", "gray_decode"]


def gray_encode(n):
    """Binary code -> Gray code (works on ints, numpy arrays or tensors)."""
    return n ^ (n >> 1)



def gray_decode(g, bits: int):
    """Gray code -> binary code via XOR-prefix (b_i = XOR of g_{n-1..i})."""
    b = g
    shift = 1
    while shift < bits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b & ((1 << bits) - 1)
