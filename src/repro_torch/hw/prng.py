"""JAX's threefry PRNG in numpy, bit for bit.

The reference draws its device noise from ``jax.random``; the port draws
the same numbers on the host with this module and moves them to the
operand's device, so the card injects the codes the CPU does. It follows
JAX 0.9 with ``jax_threefry_partitionable`` on (JAX's default there):

* a key is a (2,) uint32 array; ``PRNGKey(seed)`` is ``[0, seed]`` for a
  32-bit seed, ``fold_in(key, d)`` hashes the count pair ``(0, d)``;
* ``split(key, n)`` and the random bits hash a 64-bit iota over the
  flattened shape, split into its high and low words: ``split`` stacks the
  two output words, the 32-bit random bits are their XOR;
* ``uniform`` keeps 23 random bits as the mantissa of a float in [1, 2),
  subtracts 1, then scales: ``max(lo, f * (hi - lo) + lo)`` in float32;
* ``normal`` is ``f32(sqrt 2) * erfinv(uniform(nextafter(-1, 0), 1))``,
  with XLA's float32 erfinv (Giles' single-precision polynomials) over
  XLA's CPU ``log1p`` (a Cephes rational function for |x| < sqrt(2) - 1,
  else ``log(1 + x)`` with XLA's Cephes ``logf``,
  `repro_torch.core.quant.ref_log`), every polynomial step a fused
  multiply-add, as XLA's CPU code contracts them.

Only the noise layer's draws are covered: float32 ``uniform`` and
``normal``, 32-bit bits. Every element depends on its flat index alone,
so a large draw is made in slices of the index range on a pool of threads
(numpy releases the GIL in its loops) and joined.
"""
from __future__ import annotations

import functools
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.quant import ref_log

__all__ = ["threefry2x32", "PRNGKey", "fold_in", "split", "random_bits",
           "uniform", "normal", "erfinv", "log1p"]

_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple:
    """The Threefry-2x32 hash of the count pairs (x1, x2) under key (k1, k2):
    20 rounds, a key injection every 4."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x1, x2 = np.broadcast_arrays(np.asarray(x1, _U32), np.asarray(x2, _U32))
    with np.errstate(over="ignore"):
        a = x1 + ks[0]
        b = x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds, as JAX without x64)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key[0], key[1], 0, int(data) & 0xFFFFFFFF)
    return np.array([a, b], _U32)


def _iota_2x32(start: int, stop: int) -> tuple:
    """The high and low words of the 64-bit flat counters [start, stop)."""
    count = np.arange(start, stop, dtype=np.uint64)
    return (count >> np.uint64(32)).astype(_U32), count.astype(_U32)


_SLICE = 1 << 20  # elements per slice of a threaded draw


def _flat(fn, shape) -> np.ndarray:
    """``fn(start, stop)`` over the flat index range of ``shape``, in
    slices on a thread pool when the range is large, reshaped."""
    n = math.prod(shape)
    if n <= _SLICE:
        return fn(0, n).reshape(shape)
    bounds = [(i, min(i + _SLICE, n)) for i in range(0, n, _SLICE)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        parts = list(ex.map(lambda b: fn(*b), bounds))
    return np.concatenate(parts).reshape(shape)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys (read-only,
    memoized: the injection sites split the same keys at every call)."""
    return _split(np.asarray(key, _U32).tobytes(), int(num))


@functools.lru_cache(maxsize=4096)
def _split(key: bytes, num: int) -> np.ndarray:
    k = np.frombuffer(key, _U32)
    a, b = threefry2x32(k[0], k[1], *_iota_2x32(0, num))
    out = np.stack([a, b], axis=-1)
    out.flags.writeable = False
    return out


def _bits(key, start, stop) -> np.ndarray:
    a, b = threefry2x32(key[0], key[1], *_iota_2x32(start, stop))
    return a ^ b


def _uniform(key, start, stop, lo, hi) -> np.ndarray:
    bits = _bits(key, start, stop)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1)
    return np.maximum(lo, _fma(f, _F32(hi - lo), lo))


def _normal(key, start, stop) -> np.ndarray:
    lo = np.nextafter(_F32(-1), _F32(0), dtype=_F32)
    u = _uniform(key, start, stop, lo, _F32(1))
    return (_F32(np.sqrt(2)) * erfinv(u)).astype(_F32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit random bits of ``shape``."""
    return _flat(lambda a, b: _bits(key, a, b), tuple(shape))


def uniform(key: np.ndarray, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32."""
    lo, hi = _F32(minval), _F32(maxval)
    return _flat(lambda a, b: _uniform(key, a, b, lo, hi), tuple(shape))


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    return _flat(lambda a, b: _normal(key, a, b), tuple(shape))


# ---------------------------------------------------------------- float32

def _fma(a, b, c) -> np.ndarray:
    # float32 fused multiply-add: the product of two float32 is exact in
    # float64, so one float64 add and a cast give the fused result (up to a
    # double rounding no sweep has met)
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F32(c))
    return p


_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log1p(x: np.ndarray) -> np.ndarray:
    """float32 log1p as XLA's CPU backend computes it (x > -1)."""
    x = np.asarray(x, _F32)
    large = ref_log(torch.from_numpy(np.asarray(x + _F32(1)))).numpy()
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = (x * x2) * small
    small = x + _fma(_F32(-0.5), x2, small)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


# Giles' single-precision erfinv, w < 5 and w >= 5 (XLA's ErfInv32)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 ``jax.lax.erf_inv`` as XLA's CPU backend computes it."""
    x = np.asarray(x, _F32)
    w = -log1p(x * -x)
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3))
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(a), _F32(b)))
    with np.errstate(invalid="ignore", over="ignore"):
        return np.where(np.abs(x) == _F32(1), x * _F32(np.inf), p * x)
