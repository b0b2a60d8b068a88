"""The port's numpy copy of JAX's threefry PRNG (`repro_torch.hw.prng`)
against `jax.random` on this JAX (``jax_threefry_partitionable`` on).

* Keys, ``fold_in``, ``split``, the 32-bit random bits and ``uniform``: bit
  for bit over several seeds and shapes, 0-d and odd sizes included.
* ``normal``: the share of bit-equal draws and the largest gap in ulps are
  printed; every draw is bit-equal here, and ``round(sigma * normal)`` (what
  every injection site uses) is equal at every sigma the presets and
  ``NoiseConfig.scaled`` up to 4 produce.
* The float32 pieces under ``normal``: XLA's CPU ``log1p`` and ``erf_inv``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.hw.noise import PRESETS  # noqa: E402
from repro_torch.hw import prng  # noqa: E402

SEEDS = (0, 1, 7, 123456, 2 ** 31 - 1)
SHAPES = ((), (1,), (7,), (2, 3), (3, 5, 7), (4, 1, 9))


def _bits(a):
    return np.asarray(a).view(np.uint32)


def test_threefry_partitionable_is_on():
    """The port copies the partitionable form; the reference's draws are
    only the port's with the flag on (JAX's default here)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    k = jax.random.PRNGKey(seed)
    t = prng.PRNGKey(seed)
    np.testing.assert_array_equal(t, np.asarray(k))
    for data in (0, 1, 5120, 0x7FFFFFFF, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(t, data),
                                      np.asarray(jax.random.fold_in(k, data)))
    for n in (1, 2, 3, 7):
        np.testing.assert_array_equal(prng.split(t, n),
                                      np.asarray(jax.random.split(k, n)))
    k2, t2 = jax.random.split(k)[1], prng.split(t)[1]  # a derived key
    np.testing.assert_array_equal(prng.fold_in(t2, 42),
                                  np.asarray(jax.random.fold_in(k2, 42)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_and_uniform(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    t = prng.fold_in(prng.PRNGKey(seed), 11)
    bits = prng.random_bits(t, shape)
    assert bits.shape == shape and bits.dtype == np.uint32
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-0.99999994, 1.0), (-2.5, 3.0)):
        got = prng.uniform(t, shape, lo, hi)
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _sigmas():
    """Every scale an injection site multiplies a normal draw by: the ACAM
    sigmas as given, the conductance sigma times the 8-bit code range."""
    out = set()
    profiles = list(PRESETS.values()) + [
        {k: lam * v for k, v in PRESETS["nominal"].items()}
        for lam in (0.25, 0.5, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0)]
    for p in profiles:
        out.update({p["acam_sigma"], p["readout_sigma"],
                    p["conductance_sigma"] * 255})
    return sorted(s for s in out if s > 0)


def test_normal_bit_equal_and_codes_equal_at_every_preset_sigma():
    n = 200_000
    for seed in (0, 3):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 99)
        t = prng.fold_in(prng.PRNGKey(seed), 99)
        want = np.asarray(jax.random.normal(k, (n,)))
        got = prng.normal(t, (n,))
        gap = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        print(f"seed {seed}: {np.mean(gap == 0):.6f} of {n} normal draws "
              f"bit-equal, largest gap {gap.max()} ulp")
        np.testing.assert_array_equal(_bits(got), _bits(want))
        for sigma in _sigmas():
            np.testing.assert_array_equal(
                np.round(np.float32(sigma) * got),
                np.asarray(jnp.round(sigma * jax.random.normal(k, (n,)))),
                err_msg=f"sigma {sigma}")
    for shape in SHAPES:  # 0-d and odd sizes
        k, t = jax.random.PRNGKey(5), prng.PRNGKey(5)
        np.testing.assert_array_equal(
            _bits(prng.normal(t, shape)),
            _bits(np.asarray(jax.random.normal(k, shape))))


def test_log1p_and_erfinv_follow_xla():
    rng = np.random.default_rng(0)
    u = rng.uniform(-1, 1, 500_000).astype(np.float32)
    u[:4] = (0.0, -0.99999994, 0.99999994, 0.41421357)
    x = u * -u  # erf_inv's log1p argument, in (-1, 0]
    np.testing.assert_array_equal(
        _bits(prng.log1p(x)), _bits(jax.jit(jnp.log1p)(jnp.asarray(x))))
    y = rng.uniform(-0.4, 3.0, 100_000).astype(np.float32)  # both branches
    np.testing.assert_array_equal(
        _bits(prng.log1p(y)), _bits(jax.jit(jnp.log1p)(jnp.asarray(y))))
    np.testing.assert_array_equal(
        _bits(prng.erfinv(u)),
        _bits(jax.jit(jax.lax.erf_inv)(jnp.asarray(u))))
