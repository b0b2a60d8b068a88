"""Gray-code output encoding (paper Section V-A, Table I).

Encoding the ACAM *output* bits in Gray code halves the number of runs-of-1s
per output bit, which halves the number of stored ranges (= ACAM cells).
The binary result is recovered with an XOR prefix over the higher-order bits
(`gray_decode`), as the match-line emulation does.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gray_encode", "gray_decode", "gray_decode_bits"]


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


def gray_decode_bits(bits_array, axis: int = -1):
    """Decode a Gray bit-plane array (MSB first along ``axis``) to binary
    planes: each binary bit is the XOR of all higher-order Gray bits, the
    running sum of the 0/1 planes mod 2. numpy in, numpy out; a tensor in,
    a tensor out, in the input's dtype."""
    if isinstance(bits_array, torch.Tensor):
        moved = torch.movedim(bits_array, axis, 0)
        acc = torch.cumsum(moved.to(torch.int32), dim=0) % 2
        return torch.movedim(acc.to(bits_array.dtype), 0, axis)
    moved = np.moveaxis(bits_array, axis, 0)
    acc = np.cumsum(moved.astype(np.int32), axis=0) % 2
    return np.moveaxis(acc.astype(bits_array.dtype), 0, axis)
