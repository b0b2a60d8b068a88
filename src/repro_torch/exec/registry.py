"""RaceOp registry: named backend implementations for every paper operator.

The port of `repro.exec.registry`: the same slots, the same `BackendSpec`,
the same registration surface. The port registers the main serving path's
backends (`repro_torch.exec.backends`); the rest come with later slices.

The paper's headline claim is *reconfigurability* — RACE can run arbitrary
computations, so adapting to new DNN architectures is a software mapping
problem, not a hardware one. This module is the software side of that
claim: each operator the model stack dispatches (`OP_SLOTS`) has one or
more named backends registered against it, each with a capability
predicate, and `repro_torch.exec.plan.resolve_plan` picks exactly one per slot
for a given (ModelConfig, ExecConfig).

Adding a backend is one registration, not another ``if`` ladder::

    @register("attention_decode", "raceit_gqa_native",
              supported=lambda mcfg, ecfg: None if mcfg.n_kv_heads < mcfg.n_heads
                        else "no GQA grouping to exploit")
    def _gqa_decode(plan, q, k, v, kv_len, scale):
        ...

The registry holds *implementations*; policy (which backend a config
prefers, degrade order, override surface) lives in `repro_torch.exec.plan`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["OP_SLOTS", "BackendSpec", "register", "get_backend",
           "list_backends"]

# the dispatchable operator slots of the RACE-IT model stack, one per
# paper operator the execution mode can re-map:
#   matmul            weight matmuls (QKV/FFN/SSM projections; crossbar DPE)
#   activation        pointwise nonlinearity (Compute-ACAM LUT lane)
#   softmax           standalone softmax rows (MoE router, staged decode)
#   attention_prefill full/prefill attention (Fig. 12 pipeline)
#   attention_decode  Sq=1 KV-cache decode step
#   dd_matmul         data-dependent matmul on int8 codes (q.K^T, probs.V)
#   lm_head           the unembedding projection
OP_SLOTS = ("matmul", "activation", "softmax", "attention_prefill",
            "attention_decode", "dd_matmul", "lm_head")


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered implementation of an op slot.

    ``supported(model_cfg, exec_cfg)`` returns None when the backend can
    serve the config, else a human-readable reason string — the same
    convention as `repro.core.attention.fused_attention_supported`, which
    is exactly what the fused attention backends plug in here. ``notes``
    document runtime (shape-dependent) fallbacks the predicate cannot see.

    ``paged`` marks attention_decode backends that accept block-paged KV
    operands (``block_table``/``page_size`` kwargs — a page pool instead
    of contiguous per-slot cache rows). Callers holding a paged cache
    check it to decide between handing the pool straight to the backend
    and gathering pages back to the contiguous layout first
    (`models.layers.attention`), so pinning a non-paged backend under a
    paged serving cache degrades to a gather, recorded not raised.
    """

    slot: str
    name: str
    impl: Callable
    supported: Callable[[object, object], Optional[str]]
    notes: str = ""
    paged: bool = False


_BACKENDS: dict[str, dict[str, BackendSpec]] = {s: {} for s in OP_SLOTS}


def register(slot: str, name: str, *,
             supported: Optional[Callable] = None, notes: str = "",
             paged: bool = False):
    """Decorator: register ``impl`` as backend ``name`` for ``slot``.

    ``impl`` is called as ``impl(plan, *args, **kwargs)`` — the resolved
    `ExecPlan` comes first so backends read knobs (act_bits, softmax_mode,
    probs dtype, ...) from one place instead of threading them through
    every call site. ``paged=True`` marks attention_decode backends that
    take block-paged KV operands (see `BackendSpec.paged`).
    """
    if slot not in _BACKENDS:
        raise ValueError(f"unknown op slot {slot!r}; slots are {OP_SLOTS}")

    def deco(impl: Callable) -> Callable:
        _BACKENDS[slot][name] = BackendSpec(
            slot=slot, name=name, impl=impl,
            supported=supported or (lambda mcfg, ecfg: None), notes=notes,
            paged=paged)
        return impl

    return deco


def get_backend(slot: str, name: str) -> Optional[BackendSpec]:
    return _BACKENDS.get(slot, {}).get(name)


def list_backends(slot: Optional[str] = None) -> dict:
    """slot -> {name: BackendSpec} (or one slot's mapping).

    Forces the lazy backend import first: callers enumerating the registry
    (tests, plan error messages) must see the full population even when no
    plan has been resolved yet in the process.
    """
    from . import backends  # noqa: F401
    if slot is not None:
        return dict(_BACKENDS[slot])
    return {s: dict(b) for s, b in _BACKENDS.items()}
