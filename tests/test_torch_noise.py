"""The port's device-noise layer (`repro_torch.hw.noise` and the noisy
helpers of `repro_torch.core`) against the reference's on the same inputs.

Mirrors tests/test_exec_noise.py's surface (parse, presets, ``scaled``,
``is_clean``, hashing), then holds every injection helper to the
reference at zero, ``nominal`` and ``worst_case`` noise: `site_key`'s key
data, the codes of `perturb_weight_codes`, `fault_rows`, `jitter_codes`,
`RangeArrays.jittered` and `AcamFunction.apply_codes_noisy`, and the
outputs of `noisy_acam_softmax` (every softmax mode) and
`noisy_crossbar_linear`, bit for bit. The reference runs jitted where its
serving path is jitted (the softmax); the draws are the same either way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import acam as RA  # noqa: E402
from repro.core import crossbar as RC  # noqa: E402
from repro.core import ops as RO  # noqa: E402
from repro.core import softmax as RS  # noqa: E402
from repro.core.quant import quantize_tensor as r_quantize_tensor  # noqa: E402
from repro.hw import noise as RN  # noqa: E402
from repro_torch.core import acam as TA  # noqa: E402
from repro_torch.core import crossbar as TC  # noqa: E402
from repro_torch.core import ops as TO  # noqa: E402
from repro_torch.core import softmax as TS  # noqa: E402
from repro_torch.core.quant import quantize_tensor as t_quantize_tensor  # noqa: E402
from repro_torch.hw import noise as TN  # noqa: E402

from _torch_helpers import port_noise_config  # noqa: E402

LEVELS = ("clean", "nominal", "worst_case")
MODES = ("pot", "pot_fine", "uniform")


def _pair(level, seed=0, **kw):
    """(reference, port) NoiseConfig at a preset, fields replaced by kw."""
    r = dataclasses.replace(RN.NoiseConfig.preset(level, seed=seed), **kw)
    return r, port_noise_config(r)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------- NoiseConfig

def test_noise_config_surface_matches_reference():
    for spec in ("clean", "nominal", "worst_case", " Nominal ", "2.5", "0",
                 1.0, 3, 0.25):
        for seed in (0, 5):
            want = RN.NoiseConfig.parse(spec, seed=seed)
            got = TN.NoiseConfig.parse(spec, seed=seed)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.is_clean == want.is_clean
    assert TN.PRESETS == RN.PRESETS
    assert TN._NOMINAL == RN._NOMINAL
    nom, worst = TN.NoiseConfig.parse("nominal"), TN.NoiseConfig.parse(
        "worst_case")
    assert worst.acam_sigma == 4 * nom.acam_sigma
    assert TN.NoiseConfig.parse("2.5") == TN.NoiseConfig.scaled(2.5)
    assert TN.NoiseConfig.parse(1.0) == nom and nom.fault_rate == 0.0
    assert TN.NoiseConfig().is_clean
    assert not TN.NoiseConfig(fault_rate=0.1).is_clean
    assert hash(nom) == hash(TN.NoiseConfig.preset("nominal"))
    assert nom != TN.NoiseConfig.preset("nominal", seed=1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        nom.seed = 3
    with pytest.raises(ValueError, match="unknown noise spec"):
        TN.NoiseConfig.parse("bogus")


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_site_key_matches_reference(seed):
    nz_r, nz_t = _pair("nominal", seed)
    for tag, shape in (("matmul_resident", (1280, 3840)), ("softmax", ()),
                       ("decode_fault", (2,)), ("attn_q", (1, 8, 4, 8)),
                       ("activation_gelu", (2, 3, 5))):
        np.testing.assert_array_equal(
            TN.site_key(nz_t, tag, shape),
            np.asarray(RN.site_key(nz_r, tag, shape)))


# ------------------------------------------------------- injection helpers

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("level", LEVELS)
def test_perturb_weight_codes(level, bits):
    top = 1 << (bits - 1)
    rng = np.random.default_rng(bits)
    codes = rng.integers(-top, top, (64, 48)).astype(np.int8)
    for kw in ({}, dict(stuck_rate=0.2), dict(conductance_sigma=0.0,
                                             stuck_rate=0.05)):
        nz_r, nz_t = _pair(level, 3, **kw) if kw else _pair(level, 3)
        want = np.asarray(RN.perturb_weight_codes(
            jnp.asarray(codes), nz_r, RN.site_key(nz_r, "w", codes.shape),
            bits=bits))
        got = TN.perturb_weight_codes(_t(codes), nz_t,
                                      TN.site_key(nz_t, "w", codes.shape),
                                      bits=bits)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        if nz_t.conductance_sigma <= 0 and nz_t.stuck_rate <= 0:
            np.testing.assert_array_equal(got.numpy(), codes)


@pytest.mark.parametrize("n_rows", [1, 2, 4, 7])
def test_fault_rows(n_rows):
    for level, rate in (("clean", 0.0), ("worst_case", 0.0),
                        ("worst_case", 0.5), ("nominal", 1.0),
                        ("clean", 0.3)):
        for seed in (0, 1):
            nz_r, nz_t = _pair(level, seed, fault_rate=rate)
            want = RN.fault_rows(nz_r, RN.site_key(nz_r, "decode_fault",
                                                   (n_rows,)), n_rows)
            got = TN.fault_rows(nz_t, TN.site_key(nz_t, "decode_fault",
                                                  (n_rows,)), n_rows)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.dtype == torch.bool
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seed_0_fault_map_of_two_slots_is_the_reference_functions():
    """The map the serving tests retire: taken from the reference's
    function on this JAX, never from a pinned list."""
    nz_r, nz_t = _pair("worst_case", 0, fault_rate=0.5)
    want = np.asarray(RN.fault_rows(nz_r, RN.site_key(nz_r, "decode_fault",
                                                      (2,)), 2))
    got = TN.fault_rows(nz_t, TN.site_key(nz_t, "decode_fault", (2,)), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() == 1  # one slot dies, one survives


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("sigma", [0.0, 0.5, 2.0, 40.0])
def test_jitter_codes(sigma, dtype):
    rng = np.random.default_rng(1)
    codes = rng.integers(-128, 128, (3, 5, 17)).astype(dtype)
    key_r = jax.random.fold_in(jax.random.PRNGKey(2), 7)
    key_t = np.asarray(key_r)
    want = np.asarray(RA.jitter_codes(jnp.asarray(codes), sigma, key_r,
                                      -128, 127))
    got = TA.jitter_codes(_t(codes), sigma, key_t, -128, 127)
    assert got.dtype == _t(codes).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if sigma == 40.0:  # saturates at the clip, never wraps
        assert got.numpy().min() == -128 and got.numpy().max() == 127
    assert TN.jitter_codes is TA.jitter_codes


@pytest.mark.parametrize("name", ["gelu", "silu", "exp_pot", "log",
                                  "exp_prob"])
def test_rangearrays_jittered(name):
    hw_r, hw_t = RO.get_op(name)._hw, TO.get_op(name)._hw
    key = jax.random.PRNGKey(4)
    assert hw_t.jittered(0.0, np.asarray(key)) is hw_t
    for sigma in (0.5, 2.0):
        want, got = hw_r.jittered(sigma, key), hw_t.jittered(
            sigma, np.asarray(key))
        assert isinstance(got.lo, np.ndarray) and got.lo.dtype == np.int32
        np.testing.assert_array_equal(got.lo, want.lo)
        np.testing.assert_array_equal(got.hi, want.hi)
        pos = np.arange(RO.get_op(name).in_fmt.num_codes, dtype=np.int32)
        np.testing.assert_array_equal(got(_t(pos)).numpy(),
                                      np.asarray(want(jnp.asarray(pos))))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", ["gelu", "silu", "exp_pot", "exp_pot_fine",
                                  "exp_uniform", "log", "log_fine",
                                  "exp_prob"])
def test_apply_codes_noisy(name, level):
    op_r, op_t = RO.get_op(name), TO.get_op(name)
    nz_r, _ = _pair(level)
    rng = np.random.default_rng(5)
    n = op_r.in_fmt.num_codes
    if hasattr(op_r.in_fmt, "code_min"):
        codes = rng.integers(op_r.in_fmt.code_min, op_r.in_fmt.code_max + 1,
                             (4, 33)).astype(np.int32)
    else:
        codes = rng.integers(0, n, (4, 33)).astype(np.int32)
    key = RN.site_key(nz_r, "act", codes.shape)
    want = np.asarray(op_r.apply_codes_noisy(
        jnp.asarray(codes), key, nz_r.acam_sigma, nz_r.readout_sigma))
    got = op_t.apply_codes_noisy(_t(codes), np.asarray(key),
                                 nz_r.acam_sigma, nz_r.readout_sigma)
    np.testing.assert_array_equal(got.numpy(), want)
    if level == "clean":
        np.testing.assert_array_equal(got.numpy(),
                                      op_t.apply_codes(_t(codes)).numpy())


@pytest.mark.parametrize("mode", MODES)
def test_noisy_acam_softmax(mode):
    rng = np.random.default_rng(6)
    cases = (((3, 40), -1), ((2, 4, 1, 70), -1), ((2, 9, 5), 1))
    xs = [rng.normal(0, 3, shape).astype(np.float32) for shape, _ in cases]
    for x in xs:
        x[..., 0] = -16.0  # a masked position
    pairs = [_pair(level, 2) for level in LEVELS]
    keys = [RN.site_key(pairs[0][0], "softmax", shape) for shape, _ in cases]
    fn = jax.jit(lambda xs: [  # one jitted graph for every level and case
        [RS.noisy_acam_softmax(x, axis=axis, mode=mode, noise=nz_r, key=key)
         for x, key, (_, axis) in zip(xs, keys, cases)]
        for nz_r, _ in pairs])
    wants = fn([jnp.asarray(x) for x in xs])
    for (_, nz_t), level_wants in zip(pairs, wants):
        for x, key, (_, axis), want in zip(xs, keys, cases, level_wants):
            got = TS.noisy_acam_softmax(_t(x), axis=axis, mode=mode,
                                        noise=nz_t, key=np.asarray(key))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            if nz_t.is_clean:  # zero sigma: the clean softmax, bit for bit
                np.testing.assert_array_equal(got.numpy(), TS.acam_softmax(
                    _t(x), axis=axis, mode=mode).numpy())


@pytest.mark.parametrize("level", LEVELS)
def test_noisy_crossbar_linear(level):
    nz_r, nz_t = (_pair(level, 1) if level == "clean"
                  else _pair(level, 1, stuck_rate=0.01))
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 3, 300)).astype(np.float32)
    w = rng.normal(0, 0.1, (300, 20)).astype(np.float32)
    bias = rng.normal(0, 1, (20,)).astype(np.float32)
    wq_r = r_quantize_tensor(jnp.asarray(w), bits=8, axis=1)
    wq_t = t_quantize_tensor(_t(w), bits=8, axis=1)
    key = RN.site_key(nz_r, "xbar", w.shape)
    want = np.asarray(RC.noisy_crossbar_linear(
        jnp.asarray(x), wq_r, nz_r, key, jnp.asarray(bias)))
    got = TC.noisy_crossbar_linear(_t(x), wq_t, nz_t, np.asarray(key),
                                   _t(bias))
    np.testing.assert_array_equal(got.numpy(), want)
    clean = TC.crossbar_linear(_t(x), wq_t, _t(bias))
    assert np.array_equal(got.numpy(), clean.numpy()) == (level == "clean")


def test_draw_cache_keeps_one_draw_per_site():
    """The second use of a site reads the cache: no new draw, the same
    tensor; another scale or shape is another draw."""
    TN.clear_draw_cache()
    key = TN.site_key(TN.NoiseConfig(seed=9), "t", (4, 8))
    a = TN.normal_offsets(key, (4, 8), 0.5, "cpu")
    info = TN.draw_cache_info()
    assert info["draws"] == 1 and info["host_bytes"] == 4 * 8 * 4
    assert TN.normal_offsets(key, (4, 8), 0.5, "cpu") is a
    assert TN.draw_cache_info()["draws"] == 1
    TN.normal_offsets(key, (4, 8), 2.0, "cpu")
    TN.normal_offsets(key, (8, 4), 0.5, "cpu")
    assert TN.draw_cache_info()["draws"] == 3
    assert TN.draw_cache_info()["device_bytes"] == 0
    TN.clear_draw_cache()
    assert TN.draw_cache_info()["entries"] == 0
