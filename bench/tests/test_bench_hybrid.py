"""The hybrid cell `granite10-rag` and the chat cell `gpt2l-chat` on the
CPU: their traffic mixes, Granite's weight layout against the port's,
`yardstick.cost_hybrid` against the port's shapes and by hand,
`ssm_roofline`'s arithmetic, and tiny runs of the whole cell: the program
correct, every control (int4 codes, TF32 experts, pads scanned into the
state) not correct and the sound reorder (every layer's sums in another
order, a prompt's scan step by step) correct, judged as a run judges them,
and a broken run not correct."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("repro_torch")

import torch  # noqa: E402

from bench import run as R  # noqa: E402
from bench import weights_hybrid  # noqa: E402
from bench.faults import altered_token  # noqa: E402
from bench.traffic import generate  # noqa: E402
from bench.yardstick import cost_hybrid  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "granite10-rag"
TINY = {
    "model": dict(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=32, vocab_size=256, n_experts=8, top_k=2,
                  shared_d_ff=48, ssm_heads=16, ssm_headdim=8, ssm_state=16,
                  ssm_chunk=8),
    "serve": dict(slots=4, prefill_len=24, max_len=48),
    "mix": dict(clients=4, pool=16, blocks=8,
                prompt={"dist": "lognormal", "median": 16, "sigma": 0.3,
                        "min": 8, "max": 24},
                new_tokens={"dist": "uniform", "min": 2, "max": 6})}
_RUNS: dict = {}


def _run(control=False, fault=None, trace=False):
    """(context, entry output) of one tiny run of the cell on the CPU."""
    key = (control, fault, trace)
    if key not in _RUNS:
        torch.set_num_threads(1)
        ctx = R.context(CELL, 4_000_000_007, 0.3, trace, torch.device("cpu"),
                        control=control, fault=fault, overrides=TINY)
        _RUNS[key] = (ctx, R.entry(ctx).run(ctx))
    return _RUNS[key]


def _spec(**kw):
    ctx = R.context(CELL, 1, 1, False, None, overrides=TINY)
    return {**ctx.spec, **kw}


# --------------------------------------------------------------- traffic
@pytest.mark.parametrize("name,clients,mean_in,mean_out", [
    ("rag-qa", 32, 2700, 32), ("chat", 64, 161.31, 338)])
def test_mixes_follow_their_sources(name, clients, mean_in, mean_out):
    mix = generate.load(name)
    assert mix["kind"] == "closed_loop" and mix["clients"] == clients
    assert (mix["prompt"]["mean"], mix["new_tokens"]["mean"]) == (
        mean_in, mean_out)
    p, n = generate.mean_tokens(mix)
    # clipped stratified quantiles: within 10% of the unclipped means
    assert abs(p - mean_in) < 0.1 * mean_in
    assert abs(n - mean_out) < 0.1 * mean_out
    reqs = generate.requests(mix, 2 ** 33 + 7, 50257)
    lens = [len(q) for q, _ in reqs]
    news = [m for _, m in reqs]
    assert min(lens) >= mix["prompt"]["min"]
    assert max(lens) <= mix["prompt"]["max"]
    assert min(news) >= mix["new_tokens"]["min"]
    assert max(news) <= mix["new_tokens"]["max"]


def test_cells_fit_their_pools():
    """Every request of a mix fits its cell's slots: the admission width
    and ``max_len`` (contiguous), or the block table (paged)."""
    for cell, mix in (("granite10-rag", "rag-qa"), ("gpt2l-chat", "chat")):
        sv = json.loads((ROOT / f"bench/workloads/{cell}.json").read_text())[
            "serve"]
        m = generate.load(mix)
        width = sv.get("prefill_len", m["prompt"]["max"])
        assert m["prompt"]["max"] <= width
        assert width + m["new_tokens"]["max"] <= sv["max_len"]


# --------------------------------------------------------------- weights
def test_layout_is_the_ports():
    """Every leaf of the port's tree at the tiny size, with its shape, and
    nothing else; the mixer's leaves drawn as stated."""
    from bench.entries.serve_hybrid import port_config
    from repro_torch.models import Model
    ctx = R.context(CELL, 1, 1, False, None, overrides=TINY)
    cfg = port_config(ctx.config, ctx.spec)
    want = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = weights_hybrid.make(ctx.spec, 2 ** 40 + 3, torch.device("cpu"))

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tuple(tree.shape)
    assert dict(leaves(got)) == dict(leaves(want))
    m = got["blocks"][0]["mamba"]
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    A = torch.exp(m["A_log"])
    assert 1.0 <= float(A.min()) and float(A.max()) <= 16.0
    assert float((m["conv_x"][:-1]).abs().mean()) > 0.1  # not the identity
    assert float(m["conv_x_bias"].abs().mean()) > 0.01
    assert float((m["ssm_D"] - 1).abs().mean()) > 0.01
    assert float((got["blocks"][0]["norm1"]["scale"] - 1).abs().mean()) > 0.01


@pytest.mark.parametrize("key,value", [("d_model", 2048),
                                       ("ssm_state", 64),
                                       ("norm_eps", 1e-6),
                                       ("ssm_skip_pads", False)])
def test_port_config_held_to_the_file(key, value):
    """The port's registered configuration is held to every key of the
    cell's model description: at the file's values it is taken whole, and
    a file that differs from it stops the run, widths included, instead of
    overwriting the port."""
    from bench.entries.serve_hybrid import port_config
    ctx = R.context(CELL, 1, 1, False, None)
    cfg = port_config(ctx.config, ctx.spec)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.norm_eps) == (
        10, 4096, 128, 1e-5)
    model = {**ctx.config["model"], key: value}
    with pytest.raises(RuntimeError, match="bench's configuration"):
        port_config({**ctx.config, "model": model}, model)


def test_published_size_reckoned():
    """The cell's configuration holds 8.36 B parameters, 6.79 B of them in
    the routed experts (PERF.md's reckoning)."""
    spec = R.context(CELL, 1, 1, False, None).spec
    sizes = {}
    for path, shape, *_ in weights_hybrid.layout(spec):
        part = path[3] if path[0] == "blocks" and path[2] == "moe" \
            and path[3] != "router" else path[2] if path[0] == "blocks" \
            else path[0]
        sizes[part] = sizes.get(part, 0) + math.prod(shape)
    total = sum(sizes.values())
    experts = sizes["w1"] + sizes["w2"] + sizes["w3"]
    assert round(total / 1e9, 2) == 8.36
    assert round(experts / 1e9, 2) == 6.79
    assert round(sizes["mamba"] / 1e9, 2) == 0.92


@pytest.mark.parametrize("capacity_factor", [None, 4.0])
def test_reference_scan_forms_agree(capacity_factor):
    """`reference.granite`'s chunked SSD and its step-by-step recurrence
    give the same logits over a sequence that spans several chunks (the
    last one short), dropless and at a capacity that drops nothing."""
    from bench.reference import granite as RG
    spec = _spec()
    params = weights_hybrid.make(spec, 2 ** 35 + 11, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(4).integers(1, 256, 21))
    got = RG.forward(spec, params, toks, capacity_factor=capacity_factor)
    want = RG.forward(spec, params, toks, form="sequential")
    assert spec["ssm_chunk"] < len(toks) and len(toks) % spec["ssm_chunk"]
    assert float((got - want).abs().amax()) <= 1e-4 * float(want.std())


# ------------------------------------------------------------ yardstick
def test_counted_matrices_are_the_ports_resident_ones():
    """A decode call of one real row counts twice the multiply-adds of the
    port's resident int8 matrices (Mamba, attention, shared experts) per
    token, and the routed experts, scan and head in float32."""
    from bench.entries.serve_hybrid import port_config
    from repro_torch.models import Model, quantize_model_params
    from repro_torch.models.layers import QuantizedWeight
    ctx = R.context(CELL, 1, 1, False, None, overrides=TINY)
    spec = ctx.spec
    cfg = port_config(ctx.config, spec)
    q = quantize_model_params(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    resident = 0
    for lp in q["blocks"]:
        for part in lp.values():
            for leaf in part.values():
                if isinstance(leaf, QuantizedWeight):
                    resident += leaf.codes.numel()
    w = cost_hybrid.call_work(spec, "decode",
                              (None, torch.zeros(3, 1), None,
                               torch.tensor([9, 0, 4])),
                              {"pad_lens": torch.tensor([2, 0, 0])})
    assert w["tokens"] == 2 and w["real"].tolist() == [True, False, True]
    assert w["int8_ops"] == 2 * 2 * resident
    D, F, H, P, N = 64, 32, 16, 8, 16
    scan = 5 * P * N * H + 2 * 4 * (H * P + 2 * N)
    assert w["f32_flops"] == (9 * 2 * scan + 2 * 3 * D * F * 2 * 10 * 2
                              + 2 * D * 256 * 2)
    assert w["ssm_layers"] == 9 and w["layers"] == 1
    # attention: 7 and 4 live keys, K and V once per KV head
    assert w["attn_ops"] == 4 * 4 * 16 * (7 + 4)
    mamba = sum(leaf.codes.numel() for leaf in q["blocks"][0]["mamba"].values()
                if isinstance(leaf, QuantizedWeight))
    assert w["ssm_int8_ops"] == 2 * 2 * mamba
    state = 4 * (H * P * N + 3 * (H * P + 2 * N))
    assert w["ssm_bytes"] == mamba + 2 * 2 * state


def test_prefill_counts_real_tokens_and_a_fresh_state():
    spec = _spec()
    w = cost_hybrid.call_work(spec, "prefill",
                              (None, torch.zeros(1, 24), None),
                              {"pad_lens": torch.tensor([5])})
    assert w["tokens"] == 19 and int(w["real"].sum()) == 19
    assert w["attn_ops"] == 4 * 4 * 16 * (19 * 20 // 2)
    H, P, N = 16, 8, 16
    state = 4 * (H * P * N + 3 * (H * P + 2 * N))
    assert w["ssm_bytes"] - w["ssm_int8_ops"] // (2 * 19) == state
    with pytest.raises(ValueError):
        cost_hybrid.call_work(spec, "prefill_chunk", (None, torch.zeros(
            1, 4)), {})


def test_ssm_roofline_arithmetic():
    """The larger of compute and bytes, a Mamba layer at a time, over the
    device time under the ssm spans; None with nothing to read."""
    read = R.harness.metric_reader("ssm_roofline")
    peaks = {"int8_ops_per_s": 100.0, "f32_flops_per_s": 10.0,
             "hbm_bytes_per_s": 50.0}
    calls = [{"ssm_layers": 9, "ssm_int8_ops": 200.0, "ssm_f32_flops": 30.0,
              "ssm_bytes": 100.0},                  # compute 5 > bytes 2
             {"ssm_layers": 9, "ssm_int8_ops": 0.0, "ssm_f32_flops": 0.0,
              "ssm_bytes": 500.0}]                  # bytes 10
    run = {"profile": {"span_device_s": {"ssm": 270.0}}, "calls": calls,
           "peaks": peaks}
    assert read(run) == pytest.approx(100.0 * 9 * (5 + 10) / 270.0)
    assert read({**run, "profile": {"span_device_s": {}}}) is None
    assert read({**run, "calls": []}) is None
    assert read({**run, "calls": [{"ssm_layers": 0}]}) is None


# ------------------------------------------------------------ tiny runs
def test_program_correct_and_reference_follows_it():
    ctx, out = _run()
    r = out["readings"]
    assert r["calls"] == 9 and r["rows"] >= 9
    assert r["logit_gap"] <= 1e-5 and r["kv_err"] <= 1e-5
    assert r["state_median_l1"] <= 1e-6 and r["moe_median_l1"] <= 1e-6
    assert r["kv_median_l1"] <= 1e-6
    assert set(r["state_row_median_layers"]) == {"decode", "prefill"}
    assert [len(r["moe_row_median_layers"][k]) for k in
            ("decode", "prefill")] == [10, 10]
    assert R.result(BENCH, ctx, out, "cpu")["correct"]


@pytest.mark.parametrize("name,sound", [("apart", True), ("int4", False),
                                        ("tf32_experts", False),
                                        ("pads_scanned", False)])
def test_controls_judged_as_a_run(name, sound):
    """Each variant in the program's place, judged by `run.result`: the
    sound reorder correct, each control not; TF32 experts read on the
    routed experts' output alone, pads scanned on the admissions' states
    alone."""
    ctx, out = _run(control=True)
    v = out["variants"][name]
    assert v["sound"] == sound
    res = R.result(BENCH, ctx, {**out, "readings": v}, "cpu")
    assert res["correct"] == sound
    if name == "pads_scanned":
        by = v["state_row_median_layers"]
        assert max(by["decode"]) == 0.0 and min(by["prefill"]) > 0.01
    if name == "tf32_experts":
        assert v["state_median_l1"] == v["kv_median_l1"] == 0.0
        assert res["checks"]["moe_median_l1"]["value"] > \
            3 * res["checks"]["moe_median_l1"]["limit"]


def test_broken_run_is_not_correct():
    ctx, out = _run(fault=altered_token)
    res = R.result(BENCH, ctx, out, "cpu")
    assert not res["correct"]
    assert res["checks"]["logit_gap_mean"]["value"] > \
        res["checks"]["logit_gap_mean"]["limit"]


def test_traced_run_reports_the_cells_metrics():
    """A traced tiny run: every per-layer metric the cell lists is read or
    None (no device on the CPU); the counted calls carry the SSM work."""
    ctx, out = _run(trace=True)
    res = R.result(BENCH, ctx, out, "cpu")
    names = {m["name"] for m in R.harness.metrics_of(BENCH, CELL, True)}
    assert {"ssm_roofline", "moe_roofline", "mfu.serve"} <= names
    assert set(res["metrics"]) <= names
    assert {"batch_fill", "decode_call_ms", "prefill_call_ms",
            "mfu.serve"} <= set(res["metrics"])
    calls = out["trace"]["calls"]
    assert calls and all(c["ssm_layers"] == 9 for c in calls)
    assert all(len(c["moe_touched"]) == 10 for c in calls)
    assert np.isfinite(res["metrics"]["mfu.serve"]["value"])


def test_parent_without_the_configuration_stops_before_any_weight():
    """A port that lacks the configuration fails at its name, before the
    weights are drawn."""
    from bench.entries import serve_hybrid
    ctx = R.context(CELL, 1, 1, False, torch.device("cpu"), overrides=TINY)
    ctx.config = {**ctx.config, "port": {"arch": "no-such-model"}}
    with pytest.raises(KeyError):
        serve_hybrid.run(ctx)
