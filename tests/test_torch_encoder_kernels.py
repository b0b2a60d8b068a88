"""The contiguous Fig.-12 attention at the encoder families' shapes: the
port's plain versions against the Pallas kernels in interpret mode, bit for
bit (``out32`` and ``cmax``), in pot, pot_fine and uniform.

* 1500 keys, whisper-tiny's encoder length: three key blocks of 512, the
  last holding 476 real keys (476 = 14 x 32 + 28: runs of 32 and a split
  remainder, and run totals past 1024 keys summed again); 300 keys, one
  block that 32 does not divide. The padded tail adds exact zeros: the
  same keys in a 1536-key cache valid to 1500 give the same codes.
* Bidirectional attention under an all-true mask array at Sq = Sk (the
  encoders), Sq 300 and 1500 included: more than one 256-row block.
* Cross attention of one query over 1500 keys (a decode step of whisper's
  decoder) and of a 40-row prefill.
* The one-tile rule: each shape goes to the kernel the reference's tiling
  picks (``ng == nq == nk == 1``), traced in the reference and taken in the
  port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import acam_attention as RA  # noqa: E402
from repro_torch.kernels import acam_attention as TA  # noqa: E402

from test_torch_attention_contiguous import (MODES, _assert_equal,  # noqa: E402
                                             _both, _operands)


@pytest.fixture
def routes(monkeypatch):
    """Which kernel each side took: the reference's traced kernel body and
    the port's plain version."""
    seen = {"ref": [], "port": []}
    for side, mod, names in (
            ("ref", RA, ("_attn_kernel_single", "_attn_kernel")),
            ("port", TA, ("acam_attention_single_plain",
                          "acam_attention_contiguous_plain"))):
        for name, tag in zip(names, ("single", "two_pass")):
            inner = getattr(mod, name)

            def spy(*a, _inner=inner, _side=side, _tag=tag, **kw):
                if not seen[_side] or seen[_side][-1] != _tag:
                    seen[_side].append(_tag)
                return _inner(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return seen


def _all_true(G, Sq, Sk):
    return np.ones((G, Sq, Sk), bool)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sk", [1500, 300])
def test_encoder_key_lengths(sk, mode, routes):
    """A few rows over every key of 1500 or 300, under the all-true mask."""
    rng = np.random.default_rng(sk)
    q, k, v, s1 = _operands(rng, G=3, Sq=5, Sk=sk)
    _assert_equal(_both("codes", q, k, v, s1, mask=_all_true(3, 5, sk),
                        mode=mode))
    want = ["single"] if sk <= 512 else ["two_pass"]
    assert routes["ref"] == routes["port"] == want


@pytest.mark.parametrize("mode", MODES)
def test_last_block_of_476_real_keys(mode):
    """1500 keys as the whole array and as a 1536-key cache valid to 1500
    (scalar and per-group): the same codes, the reference's every time."""
    rng = np.random.default_rng(476)
    q, k, v, s1 = _operands(rng, G=4, Sq=1, Sk=1536)
    k1500, v1500 = (np.ascontiguousarray(a[:, :1500]) for a in (k, v))
    full = _assert_equal(_both("decode", q, k1500, v1500, s1,
                               kv_len=np.int32(1500), mode=mode))
    scalar = _assert_equal(_both("decode", q, k, v, s1,
                                 kv_len=np.int32(1500), mode=mode))
    per_group = _assert_equal(_both("decode", q, k, v, s1,
                                    kv_len=np.full(4, 1500, np.int32),
                                    mode=mode))
    np.testing.assert_array_equal(scalar, full)
    np.testing.assert_array_equal(per_group, full)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s", [64, 300, 384])
def test_bidirectional_all_true_mask(s, mode, routes):
    """Sq = Sk under the all-true mask of an encoder: one tile up to 256
    rows, the two-pass kernel past them (300: two row blocks, the second
    of 44 rows) and for G > 8 groups (bert's heads x sequences)."""
    G = 10 if s == 384 else 2
    rng = np.random.default_rng(s)
    q, k, v, s1 = _operands(rng, G=G, Sq=s, Sk=s)
    _assert_equal(_both("codes", q, k, v, s1, mask=_all_true(G, s, s),
                        mode=mode))
    want = ["single"] if s <= 256 and G <= 8 else ["two_pass"]
    assert routes["ref"] == routes["port"] == want


@pytest.mark.parametrize("mode", MODES)
def test_bidirectional_1500_rows(mode):
    """whisper's encoder: 1500 rows over 1500 keys, six row blocks of 256
    (the last of 220) by three key blocks."""
    rng = np.random.default_rng(1500)
    q, k, v, s1 = _operands(rng, G=1, Sq=1500, Sk=1500, D=8)
    _assert_equal(_both("codes", q, k, v, s1, mask=_all_true(1, 1500, 1500),
                        mode=mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sq", [1, 40])
def test_cross_attention_over_1500_keys(sq, mode, routes):
    """A decode step's cross attention (one query per head) and a prefill's
    (40 rows), 6 heads over 1500 encoder keys, the all-true mask of kind
    ``cross``: the two-pass kernel (three key blocks), as in the
    reference."""
    rng = np.random.default_rng(sq)
    q, k, v, s1 = _operands(rng, G=6, Sq=sq, Sk=1500)
    _assert_equal(_both("codes", q, k, v, s1, mask=_all_true(6, sq, 1500),
                        mode=mode))
    assert routes["ref"] == routes["port"] == ["two_pass"]


@pytest.mark.parametrize("G,Sq,Sk", [
    (6, 1, 1500), (6, 64, 1500), (6, 1500, 1500), (128, 384, 384),
    (96, 384, 384), (6, 64, 64), (6, 1, 512), (8, 256, 512), (9, 1, 64),
    (2, 300, 300), (6, 1, 513), (12, 6, 1024)])
def test_one_tile_rule_is_the_reference_tiling(G, Sq, Sk):
    """`one_tile` at the encoder families' shapes equals the reference's
    ``ng == nq == nk == 1`` from its block sizes."""
    bg = min(RA.DEFAULT_BLOCK_G, G)
    bq = min(RA.DEFAULT_BLOCK_Q, max(8, Sq))
    bk = min(RA.DEFAULT_BLOCK_K, max(128, Sk))
    want = -(-G // bg) == -(-Sq // bq) == -(-Sk // bk) == 1
    assert TA.one_tile(G, Sq, Sk) == want
    assert TA.key_block(Sk) == bk


def test_one_tile_routes_whisper_calls():
    """The calls whisper-tiny makes at full width: decoder self-attention
    prefill (P <= 256 rows, one key block) and decode (512 columns) on one
    tile; encoder, cross prefill and cross decode on the two-pass kernel."""
    assert TA.one_tile(6, 64, 64) and TA.one_tile(6, 1, 512)
    assert not any(TA.one_tile(6, sq, 1500) for sq in (1, 64, 1500))
    assert not TA.one_tile(128, 384, 384)  # bert-large, 8 sequences


def test_mask_of_kind_cross_is_all_keys():
    """`_mask_fn("cross")` admits every key, as the reference's does."""
    from repro.exec import backends as RB
    from repro_torch.exec import backends as TB
    want = RB._mask_array("cross", 2, 3, 7, 0, 4)
    got = TB._mask_array("cross", 2, 3, 7, 0, 4)
    assert got.all() and tuple(got.shape) == (2, 3, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    qi, ki = torch.arange(3)[:, None], torch.arange(7)[None, :]
    fn = TB._mask_fn("cross", 7, 0, 4)(qi, ki)
    assert bool((fn & (ki < 7)).all())
    assert bool(jnp.all(RB._mask_fn("cross", 7, 0, 4)(
        jnp.arange(3)[:, None], jnp.arange(7)[None, :])))
