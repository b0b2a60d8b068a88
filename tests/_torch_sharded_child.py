"""The reference's tensor-parallel paths on 8 simulated devices, for the
port's TP tests (not collected; run as a script by
tests/test_torch_sharded.py and tests/test_torch_sharded_serving.py).

    python tests/_torch_sharded_child.py ops OUT.npz
    python tests/_torch_sharded_child.py moe OUT.npz
    python tests/_torch_sharded_child.py fsdp OUT.npz

It runs under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``: the
parent pytest process pins JAX to one CPU device (tests/conftest.py), and
the flag only takes effect before JAX initializes, so a sharded reference
path runs only in a child process.

``ops``: the reference's ``raceit_fused_tp`` / ``raceit_gqa_tp`` backends,
resolved by `resolve_plan` on a ``model=2`` and a ``model=4`` mesh, for
MHA (8/8 heads) and GQA (16/8): causal and padded-bucket prefill,
contiguous decode with per-row ``kv_len``, a contiguous chunk step, paged
decode and a paged chunk step. Every call is jitted, and it must be jit
against jit: the port follows XLA's jitted float32 graph (a division by a
constant is a reciprocal multiply there, scale products fold their
constants), and eager JAX rounds those epilogues differently by an ulp.
Each shard's integer values are captured inside the jitted graph with
`jax.debug.callback` (tagged with the shard's `axis_index`): the codes and
scale of every ``tp_*`` quantizer call, in trace order, and the exact
call's ``out32`` and ``cmax``.

``moe``: the reference's sharded `moe` (jitted): tiny mixtral with
TP-in-expert at model=2, tiny llama4-scout with EP at model 2 and 4, a
decode step (S=1) and a 16-token prefill, digital and raceit, at capacity
factor 1.25 (choices drop). Each shard's routing (expert ids, gates,
kept choices, dispatch slots) is captured the same way.

``fsdp``: the reference's `GenerationEngine` serving on a data=2,model=2
mesh, its tree placed under `param_specs` with the FSDP axis map: tiny
gpt2-large and command-r-35b (``fsdp`` set) and tiny mixtral-8x22b, from
``Model.init(PRNGKey(0))``, resident int8 (``raceit``). Greedy tokens of
`generate` and of mixed-length `ContinuousBatcher` traces (paged where
the model pages).

The inputs are tests/_torch_sharded_cases.py's (numpy seeds); the npz
holds the outputs and records under ``<case>/<name>`` keys. Prints
CHILD_OK on success.
"""
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.dist import MeshSpec  # noqa: E402
from repro.exec.plan import resolve_plan  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.models import moe as RM  # noqa: E402

from _torch_sharded_cases import (DATAFLOWS, FSDP_MAX_LEN,  # noqa: E402
                                  FSDP_MESH, FSDP_MODELS, FSDP_SEEDS,
                                  MOE_CASES, MOE_CF, MOE_MODES, OPS_CONFIGS,
                                  OPS_MESHES, config_kw, drive_trace,
                                  fsdp_batcher_kw, fsdp_prompts, fsdp_trace,
                                  moe_inputs, ops_call, ops_inputs)


class Recorder:
    """Captures each shard's values inside a jitted graph: a label per
    call site in trace order, the shard's ``axis_index``."""

    def __init__(self):
        self.records = {}
        self.n_calls = 0

    def reset(self):
        self.records = {}
        self.n_calls = 0

    def emit(self, label, axis, **values):
        def store(shard, *arrays):
            for name, a in zip(values, arrays):
                self.records[(label, name, int(shard))] = np.asarray(a)
        jax.debug.callback(store, jax.lax.axis_index(axis), *values.values())

    def label(self, kind):
        self.n_calls += 1
        return f"{kind}{self.n_calls - 1}"

    def stacked(self):
        """{"label/name": (n_shards, ...)} arrays."""
        out = {}
        keys = sorted({(lab, name) for lab, name, _ in self.records})
        for lab, name in keys:
            shards = sorted(s for l2, n2, s in self.records
                            if (l2, n2) == (lab, name))
            out[f"{lab}/{name}"] = np.stack(
                [self.records[(lab, name, s)] for s in shards])
        return out


def patch_tp_ops(rec):
    """Wrap the reference's tp_* helpers so every call records its shard's
    codes, scale, out32 and cmax."""
    orig = {n: getattr(kops, n) for n in (
        "tp_quantize_tensor", "tp_masked_prefix_quantize",
        "tp_masked_page_quantize", "tp_exact_call")}

    def quant(x, axis_name, *a, **k):
        out = orig["tp_quantize_tensor"](x, axis_name, *a, **k)
        rec.emit(rec.label("quant"), axis_name, codes=out.codes,
                 scale=out.scale)
        return out

    def masked(name):
        def fn(x, lens, axis_name, *a, **k):
            codes, scale = orig[name](x, lens, axis_name, *a, **k)
            rec.emit(rec.label("quant"), axis_name, codes=codes, scale=scale)
            return codes, scale
        return fn

    def exact(call, axis_name):
        out32, cmax = orig["tp_exact_call"](call, axis_name)
        rec.emit(rec.label("exact"), axis_name, out32=out32, cmax=cmax)
        return out32, cmax

    kops.tp_quantize_tensor = quant
    kops.tp_masked_prefix_quantize = masked("tp_masked_prefix_quantize")
    kops.tp_masked_page_quantize = masked("tp_masked_page_quantize")
    kops.tp_exact_call = exact


def run_ops(out):
    rec = Recorder()
    patch_tp_ops(rec)
    for tag, shape in OPS_CONFIGS.items():
        cfg = get_config("gpt2-large").replace(**config_kw(*shape))
        x = ops_inputs(tag)
        jx = {k: jnp.asarray(v) for k, v in x.items()}
        scale = 1.0 / float(np.sqrt(cfg.resolved_head_dim))
        for ms in OPS_MESHES:
            plan = resolve_plan(cfg, ExecConfig.serving(
                mesh=MeshSpec.parse(f"model={ms}")))
            out[f"{tag}/m{ms}/backends"] = np.array(
                [plan.backend("attention_prefill"),
                 plan.backend("attention_decode")])
            for name in DATAFLOWS:
                rec.reset()
                y = jax.block_until_ready(jax.jit(
                    lambda: ops_call(plan, name, jx, scale))())
                case = f"{tag}/m{ms}/{name}"
                out[f"{case}/out"] = np.asarray(y)
                for k, v in rec.stacked().items():
                    out[f"{case}/{k}"] = v
                print(f"  {case}: {len(rec.records)} shard records",
                      flush=True)


# ---------------------------------------------------------------------- moe

def moe_config(name):
    from conftest import tiny_config
    return tiny_config(get_config(name)).replace(capacity_factor=MOE_CF)


def moe_exec(mode):
    return (ExecConfig.serving(mode="raceit") if mode == "raceit"
            else ExecConfig(mode="digital"))


def patch_moe_routing(rec):
    """Wrap the reference's per-shard body so each shard records its
    routing, computed by the body's own ops on the same operands."""
    orig = RM._moe_local

    def body(p, x, cfg, plan, axis, tp_size):
        y = orig(p, x, cfg, plan, axis, tp_size)
        Bl, S, D = x.shape
        E, K = cfg.n_experts, cfg.top_k
        T = Bl * S
        xf = x.reshape(T, D)
        logits = (xf.astype(jnp.float32) @ p["router"]).astype(jnp.float32)
        probs = plan.softmax(logits, axis=-1)
        gate, expert = jax.lax.top_k(probs, K)
        gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
        C = max(1, int(-(-K * T * cfg.capacity_factor // E)))
        e_flat = expert.reshape(-1)
        order = jnp.argsort(e_flat, stable=True)
        sorted_e = e_flat[order]
        starts = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
        rank_sorted = jnp.arange(T * K, dtype=jnp.int32) - starts[sorted_e]
        rank = jnp.zeros((T * K,), jnp.int32).at[order].set(rank_sorted)
        keep = rank < C
        slot = jnp.where(keep, e_flat * C + rank, E * C)
        rec.emit("route", axis, expert=expert, gate=gate, keep=keep,
                 slot=slot, C=jnp.asarray(C, jnp.int32))
        return y

    RM._moe_local = body


def run_moe(out):
    rec = Recorder()
    patch_moe_routing(rec)
    for i, (tag, name, ms, b, s) in enumerate(MOE_CASES):
        cfg = moe_config(name)
        x, p = moe_inputs(i, b, s, cfg.d_model, cfg.n_experts, cfg.d_ff,
                          cfg.glu)
        ctx = MeshSpec.parse(f"model={ms}").context()
        for mode in MOE_MODES:
            plan = resolve_plan(cfg, moe_exec(mode))
            rec.reset()
            y = jax.block_until_ready(jax.jit(
                lambda p, x: RM.moe(p, x, cfg, plan, ctx))(
                    {k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x)))
            case = f"{tag}/{mode}"
            out[f"{case}/out"] = np.asarray(y)
            for k, v in rec.stacked().items():
                out[f"{case}/{k}"] = v
            print(f"  {case}: {len(rec.records)} shard records", flush=True)


def fsdp_config(name):
    from conftest import tiny_config
    return tiny_config(get_config(name)).replace(fsdp=True)


def run_fsdp(out):
    from repro.models import Model
    from repro.models.model import quantize_model_params
    from repro.serve import ContinuousBatcher, GenerationEngine, Request
    for name in FSDP_MODELS:
        cfg = fsdp_config(name)
        params = quantize_model_params(Model(cfg).init(jax.random.PRNGKey(0)))
        eng = GenerationEngine(cfg, params, exec_cfg=ExecConfig.serving(
            mode="raceit", mesh=MeshSpec.parse(FSDP_MESH)),
            max_len=FSDP_MAX_LEN)
        leaf = eng.params["embed"]["tok_emb"]
        assert len(leaf.sharding.device_set) == 4, leaf.sharding
        out[f"{name}/generate"] = np.asarray(
            eng.generate(jnp.asarray(fsdp_prompts()), n_new=6))
        paged = ContinuousBatcher.pageable_reason(eng) is None
        out[f"{name}/paged"] = np.asarray(paged)
        for seed in FSDP_SEEDS:
            cb = ContinuousBatcher(eng, paged=paged, **fsdp_batcher_kw(paged))
            got = drive_trace(cb, fsdp_trace(seed, cfg.vocab_size), Request)
            for rid, toks in got.items():
                out[f"{name}/trace{seed}/{rid}"] = np.asarray(toks, np.int32)
        print(f"  {name}: decode {eng.plan.backend('attention_decode')}, "
              f"paged {paged}", flush=True)


def main():
    mode, path = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 8, jax.devices()
    out = {}
    {"ops": run_ops, "moe": run_moe, "fsdp": run_fsdp}[mode](out)
    np.savez(path, **out)
    print("CHILD_OK")


if __name__ == "__main__":
    main()
