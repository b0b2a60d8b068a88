"""The encoder-only models of the port (bert-base, bert-large) against the
reference, at `tests/conftest.py` `tiny_config` size (2 layers, d_model 64,
4 heads of 16, vocab 256, bidirectional attention, learned positions, qkv
biases, LayerNorm, GELU).

* The configurations are the reference's field for field, and in `PORTED`.
* `layers.max_positions` at the **full** configurations gives the
  reference's learned position table: 8192 rows for an encoder (the
  reference's `init_embeddings`, traced with `jax.eval_shape`), whatever
  ``max_seq_len`` says; a tiny config cannot tell the rules apart.
* `Model.forward` against the reference's jitted `Model.forward` on the
  same float weights: digital logits within `ATOL` (float32 sums in other
  orders); raceit_q8 (resident int8 weights, the fused kernels' plain
  versions against the Pallas kernel in interpret mode) with every
  attention call's int32 ``out`` and ``cmax`` bit-equal, captured inside
  the reference's jitted graph, and the logits within `ATOL`.
* `plan.explain()` line for line; a reference checkpoint (`leaves.npz`)
  crosses over to the same logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as RKO  # noqa: E402
import repro_torch.kernels.ops as TKO  # noqa: E402
from repro.ckpt import CheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.exec import resolve_plan as r_resolve  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import quantize_model_params as r_quantize  # noqa: E402
from repro_torch.ckpt import load_reference_checkpoint  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs.catalog import PORTED  # noqa: E402
from repro_torch.exec import resolve_plan as t_resolve  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import quantize_model_params as t_quantize  # noqa: E402

from _torch_helpers import (port_exec_config, port_model_config,  # noqa: E402
                            port_params)
from conftest import tiny_config  # noqa: E402

MODELS = ("bert-base", "bert-large")
MODES = ("digital", "raceit_q8")
# logits of the tiny models reach about 4; float32 sums in other orders
ATOL = 2e-5


def _exec(mode):
    return (ExecConfig.serving(mode="raceit") if mode == "raceit_q8"
            else ExecConfig(mode="digital"))


def _weights(cfg, mode, seed=3):
    """(reference params, port params) on the same float weights, resident
    int8 in raceit_q8."""
    p = RModel(cfg).init(jax.random.PRNGKey(seed))
    tp = port_params(p, cfg)
    if mode == "raceit_q8":
        return r_quantize(p), t_quantize(tp)
    return p, tp


def capture_codes(monkeypatch):
    """Lists of every attention call's (out32, cmax) in the reference
    (captured inside its jitted graph) and in the port."""
    ref, port = [], []
    r_fn, t_fn = RKO.acam_attention_codes, TKO.acam_attention_codes

    def r_wrapped(*a, **k):
        out32, cmax = r_fn(*a, **k)
        jax.debug.callback(lambda o, c: ref.append(
            (np.asarray(o), int(c))), out32, cmax)
        return out32, cmax

    def t_wrapped(*a, **k):
        out32, cmax = t_fn(*a, **k)
        port.append((out32.numpy().copy(), int(cmax)))
        return out32, cmax
    monkeypatch.setattr(RKO, "acam_attention_codes", r_wrapped)
    monkeypatch.setattr(TKO, "acam_attention_codes", t_wrapped)
    return ref, port


def assert_codes_equal(ref, port, n_calls):
    assert len(ref) == len(port) == n_calls
    for (ro, rc), (to, tc) in zip(ref, port):
        assert rc == tc
        np.testing.assert_array_equal(to.reshape(ro.shape), ro)


def _tokens(cfg, seed=0, B=2, S=24):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("name", MODELS)
def test_configs_are_the_reference(name):
    assert name in PORTED
    assert port_model_config(get_config(name)) == t_get(name)


@pytest.mark.parametrize("name", MODELS + ("whisper-tiny", "qwen2-vl-2b",
                                           "gpt2-large"))
def test_max_positions_at_full_config(name):
    """The learned position table's rows at the published configuration:
    an encoder's is 8192 (its max_seq_len of 524288 would give 65536)."""
    cfg = get_config(name)
    shapes = jax.eval_shape(lambda k: RL.init_embeddings(k, cfg, jnp.float32),
                            jax.random.PRNGKey(0))
    want = shapes["pos_emb"].shape[0] if "pos_emb" in shapes else None
    if name.startswith("bert"):
        assert want == 8192
    if want is not None:
        assert TL.max_positions(t_get(name)) == want


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_the_reference(name, mode, monkeypatch):
    cfg = tiny_config(get_config(name))
    assert not cfg.causal and cfg.family == "encoder"
    p, tp = _weights(cfg, mode)
    tok = _tokens(cfg)
    ref_codes, port_codes = capture_codes(monkeypatch)
    rm = RModel(cfg, _exec(mode))
    want = np.asarray(jax.jit(lambda p, b: rm.forward(p, b, use_remat=False))(
        p, {"tokens": jnp.asarray(tok)}))
    tm = TModel(port_model_config(cfg), port_exec_config(_exec(mode)),
                device="cpu")
    got = tm.forward(tp, {"tokens": torch.from_numpy(tok)}).numpy()
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if mode == "raceit_q8":
        assert_codes_equal(ref_codes, port_codes, cfg.n_layers)
    else:
        assert not ref_codes and not port_codes


@pytest.mark.parametrize("name", MODELS)
def test_forward_takes_given_positions(name):
    """``batch["positions"]`` reaches the learned table, as in the
    reference: shifted positions give other logits, the reference's."""
    cfg = tiny_config(get_config(name))
    p, tp = _weights(cfg, "digital", seed=6)
    tok = _tokens(cfg, seed=2, S=10)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32) + 7, (2, 10)).copy()
    want = np.asarray(RModel(cfg).forward(
        p, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
        use_remat=False))
    tm = TModel(port_model_config(cfg), device="cpu")
    got = tm.forward(tp, {"tokens": torch.from_numpy(tok),
                          "positions": torch.from_numpy(pos)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    plain = tm.forward(tp, {"tokens": torch.from_numpy(tok)}).numpy()
    assert np.abs(plain - got).max() > 1e-3


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("which", ["serving-raceit", "serving", "digital"])
@pytest.mark.parametrize("name", MODELS)
def test_plan_explain(name, which):
    ec = {"serving-raceit": ExecConfig.serving(mode="raceit"),
          "serving": ExecConfig.serving(),
          "digital": ExecConfig(mode="digital")}[which]
    cfg = tiny_config(get_config(name))
    want = r_resolve(cfg, ec).explain().splitlines()
    got = t_resolve(port_model_config(cfg), port_exec_config(ec))
    assert got.explain().splitlines() == want


# ------------------------------------------------------------- checkpoint

@pytest.mark.parametrize("name", MODELS)
def test_reference_checkpoint_crosses_over(tmp_path, name):
    cfg = tiny_config(get_config(name))
    params = RModel(cfg).init(jax.random.PRNGKey(5))
    CheckpointManager(str(tmp_path)).save(1, params)
    tcfg = port_model_config(cfg)
    loaded = load_reference_checkpoint(tmp_path, tcfg, device="cpu")
    in_memory = port_params(params, cfg)
    assert len(loaded["blocks"]) == cfg.n_layers
    assert loaded["embed"]["pos_emb"].shape[0] == 8192
    for got, want in zip(loaded["blocks"], in_memory["blocks"]):
        assert sorted(got) == sorted(want)
        for group in want:
            for leaf in want[group]:
                assert torch.equal(got[group][leaf], want[group][leaf])
    tok = _tokens(cfg, seed=4, S=12)
    model = TModel(tcfg, device="cpu")
    a = model.forward(loaded, {"tokens": torch.from_numpy(tok)})
    b = model.forward(in_memory, {"tokens": torch.from_numpy(tok)})
    assert torch.equal(a, b)
    rl = RModel(cfg).forward(params, {"tokens": jnp.asarray(tok)},
                             use_remat=False)
    np.testing.assert_allclose(a.numpy(), np.asarray(rl), rtol=0, atol=ATOL)
