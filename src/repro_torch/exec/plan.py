"""ExecPlan: one resolved backend per op slot, chosen once per config.

The port of `repro.exec.plan`, with the same `_default_chain` — so a
(ModelConfig, ExecConfig) pair asks for the same backends in both packages.
Chain entries the port has not registered yet degrade like any unsupported
backend, with the reason recorded on the plan; a slot whose whole chain and
baseline are unported resolves to a stub that raises when called (no slot
of the paged serving path is such a slot).

`resolve_plan(model_cfg, exec_cfg)` turns the declarative `ExecConfig`
(mode / softmax_mode / fidelity / fused_attention / op_overrides) into an
`ExecPlan`: for every `OP_SLOTS` entry, a preference chain of backend names
is built, capability predicates are evaluated, and the first supported
backend wins. Unsupported requests **degrade, never raise** — each degrade
is recorded as a structured `Degrade` (slot, requested, chosen, reason) on
the plan, and `plan.explain()` renders the whole table. A one-time
RuntimeWarning is kept for the fused-attention degrade (back-compat with
the pre-plan `_resolve_fused` behavior).

The model stack calls ``plan.attention_decode(...)`` / ``plan.matmul(...)``
etc. instead of branching on ``exec_cfg.mode`` — `models/` and `serve/`
contain no mode conditionals; registering a new backend (a GQA-native
decode kernel, a TPU-tuned block variant, a new accelerator) is one
`repro_torch.exec.registry.register` call plus, optionally, a preference-chain
entry here.

Resolution is pure and cached: the same (ModelConfig, ExecConfig) pair
always resolves to the same plan object, so per-layer `as_plan` calls are
free and jit closures share one plan.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

from .. import trace
from ..configs.base import ExecConfig, ModelConfig

from .registry import OP_SLOTS, BackendSpec, get_backend, list_backends

__all__ = ["ExecPlan", "ResolvedOp", "Degrade", "resolve_plan", "as_plan",
           "layer_plan", "reset_plan_cache"]

_DEGRADE_WARNED: set = set()  # one-time fused-attention degrade warnings


@dataclasses.dataclass(frozen=True)
class Degrade:
    """Structured record of one resolution downgrade."""

    slot: str
    requested: str
    chosen: str
    reason: str


@dataclasses.dataclass(frozen=True)
class ResolvedOp:
    slot: str
    backend: str          # chosen backend name
    requested: str        # head of the preference chain (what config asked)
    reason: Optional[str]  # why requested != backend (None when equal)
    spec: BackendSpec = dataclasses.field(compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """Resolved dispatch table: the single operator-dispatch API.

    Layers call the slot methods below; each forwards to the resolved
    backend impl with the plan itself as first argument, so backends read
    quantization knobs from ``plan.exec_cfg`` and perf knobs from
    ``plan.model_cfg`` — no more bare ``ExecConfig(mode="raceit")``
    reconstructions dropping the caller's bit-width settings.
    """

    model_cfg: ModelConfig
    exec_cfg: ExecConfig
    ops: tuple[ResolvedOp, ...]
    degrades: tuple[Degrade, ...] = ()

    # ------------------------------------------------------------ accessors
    @functools.cached_property
    def _by_slot(self) -> dict:
        return {op.slot: op for op in self.ops}

    def op(self, slot: str) -> ResolvedOp:
        return self._by_slot[slot]

    def backend(self, slot: str) -> str:
        return self._by_slot[slot].backend

    # ------------------------------------------------------- slot dispatch
    def matmul(self, x, w, bias=None):
        """x (..., K) @ w (K, ...); w may be a resident `QuantizedWeight`."""
        with trace.span("plan.matmul"):
            return self.op("matmul").spec.impl(self, x, w, bias)

    def activation(self, x, name=None):
        """Pointwise nonlinearity. ``name`` comes from the call site's
        ModelConfig (sub-stacks may run a replaced config); None falls back
        to the plan's model_cfg."""
        with trace.span("plan.activation"):
            return self.op("activation").spec.impl(self, x, name)

    def softmax(self, logits, axis=-1):
        with trace.span("plan.softmax"):
            return self.op("softmax").spec.impl(self, logits, axis)

    def attention_prefill(self, q, k, v, *, scale, q_offset, kind, window,
                          chunk, probs_dtype=None, pad_lens=None):
        """Full/prefill attention. q (B,Sq,H,hd) flat heads; k/v (B,Sk,KV,hd).

        ``kind`` in ("cross", "bidir", "local", "causal") names the mask
        structure; it comes from the *call site's* ModelConfig (encoder
        sub-stacks pass a replaced config), as do ``window`` and
        ``probs_dtype`` (the float paths' p-matrix dtype). ``pad_lens``
        (B,) int32 marks per-row left-pad key prefixes that must be masked
        on top of the structural mask (batched-serving buckets).
        """
        with trace.span("plan.attention_prefill"):
            return self.op("attention_prefill").spec.impl(
                self, q, k, v, scale=scale, q_offset=q_offset, kind=kind,
                window=window, chunk=chunk, probs_dtype=probs_dtype,
                pad_lens=pad_lens)

    def attention_decode(self, q, k, v, *, kv_len, scale, pad_valid=None,
                         block_table=None, page_size=None):
        """Decode step (Sq=1, or an Sq=C chunked-prefill step) vs a
        fixed-shape cache valid to ``kv_len``.

        ``pad_valid`` (B, Smax) bool further restricts each row's
        attendable slots inside the prefix (left-padded buckets); a
        (B, Sq, Smax) form carries the chunk step's per-query causal mask.
        ``block_table``/``page_size`` hand a block-paged KV pool to a
        paged-capable backend (`BackendSpec.paged`) — callers check the
        flag and gather pages to contiguous rows first for non-paged
        backends, so the kwargs are only forwarded when actually paged.
        """
        spec = self.op("attention_decode").spec
        with trace.span("plan.attention_decode"):
            if block_table is None:  # contiguous callers: unchanged interface
                return spec.impl(self, q, k, v, kv_len=kv_len, scale=scale,
                                 pad_valid=pad_valid)
            return spec.impl(self, q, k, v, kv_len=kv_len, scale=scale,
                             pad_valid=pad_valid, block_table=block_table,
                             page_size=page_size)

    def dd_matmul(self, a_codes, b_codes):
        """Data-dependent matmul on int8 codes -> int32."""
        with trace.span("plan.dd_matmul"):
            return self.op("dd_matmul").spec.impl(self, a_codes, b_codes)

    def lm_head(self, x, w):
        with trace.span("plan.lm_head"):
            return self.op("lm_head").spec.impl(self, x, w)

    # ------------------------------------------------------------- explain
    def explain(self) -> str:
        """Human-readable slot -> backend table with degrade reasons.

        Renders every resolved slot *and* every plan-level degrade that has
        no slot row — an override naming an unknown slot, or an unknown
        execution mode — so a typo'd ``--exec-plan`` pin is visible in the
        startup table instead of silently ignored.
        """
        lines = [f"ExecPlan(mode={self.exec_cfg.mode!r}, "
                 f"softmax={self.exec_cfg.softmax_mode!r}, "
                 f"fidelity={self.exec_cfg.matmul_fidelity!r})"]
        width = max(len(s) for s in OP_SLOTS)
        for op in self.ops:
            line = f"  {op.slot:<{width}} -> {op.backend}"
            if op.reason is not None:
                line += f"  (requested {op.requested}: {op.reason})"
            if op.spec.notes:
                line += f"  [{op.spec.notes}]"
            lines.append(line)
        slots = {op.slot for op in self.ops}
        for d in self.degrades:
            if d.slot not in slots:  # unknown slot / unknown mode records
                lines.append(f"  ! {d.slot} -> {d.chosen or '(dropped)'}  "
                             f"(requested {d.requested}: {d.reason})")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# resolution policy
# ---------------------------------------------------------------------------

# the digital baseline per slot — also the last-resort landing spot when a
# whole preference chain is unsupported (dd_matmul's baseline is the exact
# integer matmul: there is no float form of a matmul on int8 codes)
_BASELINE = {slot: ("int",) if slot == "dd_matmul" else ("digital",)
             for slot in OP_SLOTS}


def _default_chain(slot: str, exec_cfg: ExecConfig) -> tuple[str, ...]:
    """Preference order for a slot under this ExecConfig (head = requested)."""
    if exec_cfg.mode != "raceit":  # digital baseline (and unknown modes,
        return _BASELINE[slot]     # which degrade below with a reason)
    noisy = exec_cfg.noise is not None
    fused_first = ("raceit_fused", "raceit_staged", "digital")
    staged_first = ("raceit_staged", "digital")
    if noisy:
        # device-noise injection rides the staged path: the noisy backends
        # head the chains, and a fused_attention=True request keeps the
        # fused names at the head so the degrade (the fused kernels model
        # ideal devices) is *recorded* on the plan — plus the one-time
        # warning below, via the existing machinery.
        staged_first = ("raceit_noisy_staged",) + staged_first
        fused_first = ("raceit_fused", "raceit_noisy_staged",
                       "raceit_staged", "digital")
    # decode prefers the per-row GQA-native kernel: per-request kv_len
    # vectors (slot-level continuous batching) decode each row at its own
    # fill level, and scalar-kv_len callers pass through unchanged. The
    # GQA predicates accept only configs with KV-head sharing
    # (n_kv_heads < n_heads), so MHA configs degrade within the fused
    # family to the per-row flat kernel with the reason recorded — same
    # dataflow there, nothing to warn about.
    # ... and, ahead of both row families, their paged twins: the paged
    # backends serve contiguous callers unchanged (block_table=None
    # delegates to the same row/flat adapters) and additionally accept the
    # block-paged KV pool of `repro_torch.serve.continuous`'s paged mode, so
    # resolving them by default costs nothing and makes every serving
    # config paged-capable without an override.
    gqa_first = ("raceit_gqa_paged", "raceit_gqa_rows", "raceit_gqa_native",
                 "raceit_fused_paged", "raceit_fused_rows") + fused_first
    # a model-axis mesh on the config puts the tensor-parallel family at
    # the head of the attention chains: the TP predicates are structural
    # (model_size > 1, n_kv_heads % model_size == 0, fused support), so a
    # 1-device mesh — or a non-dividing head count — degrades to exactly
    # the single-device chain below, recorded on the plan, never raised.
    if getattr(exec_cfg.mesh, "model_size", 1) > 1:
        fused_first = ("raceit_fused_tp",) + fused_first
        gqa_first = ("raceit_gqa_tp", "raceit_fused_tp") + gqa_first
    return {
        "matmul": (("raceit_noisy_int", "raceit_int") if noisy
                   else ("raceit_int",)),
        "activation": (("raceit_noisy_lut", "raceit_lut") if noisy
                       else ("raceit_lut",)),
        "softmax": (("raceit_noisy_acam", "raceit_acam") if noisy
                    else ("raceit_acam",)),
        "dd_matmul": (("acam", "int") if exec_cfg.matmul_fidelity == "acam"
                      else ("int",)),
        "attention_prefill": (fused_first if exec_cfg.fused_attention
                              else staged_first),
        "attention_decode": (gqa_first if exec_cfg.fused_attention
                             else staged_first),
        # the lm head stays full-precision by default even in raceit mode
        # (resident int8 weights still take the quantized path inside the
        # backend); override lm_head=raceit_q8 to quantize it like any
        # other crossbar matmul
        "lm_head": ("digital",),
    }[slot]


def _unported(slot: str) -> BackendSpec:
    """Stub for a slot with no ported backend: resolves, raises when called."""
    def impl(plan, *args, **kwargs):
        raise NotImplementedError(
            f"op slot {slot!r} has no backend in repro_torch yet "
            f"(plan.explain() lists what is ported)")
    return BackendSpec(slot=slot, name="unported", impl=impl,
                       supported=lambda mcfg, ecfg: None,
                       notes="not ported yet; raises when called")


def _ensure_backends_loaded() -> None:
    # backend impls live next to the math they wrap (repro_torch.exec.backends
    # imports models.layers); import lazily to avoid a load-time cycle
    from . import backends  # noqa: F401


@functools.lru_cache(maxsize=None)
def resolve_plan(model_cfg: ModelConfig,
                 exec_cfg: ExecConfig = ExecConfig()) -> ExecPlan:
    """Pick one backend per op slot for this (model, execution) config.

    Policy: per slot, start from the ``exec_cfg.op_overrides`` entry when
    present, then the mode's default preference chain; the first backend
    whose capability predicate accepts the config wins. Every skipped
    preference is recorded as a `Degrade`; nothing raises — an impossible
    request serves the best supported backend and says so in
    ``plan.explain()``.
    """
    _ensure_backends_loaded()
    overrides = dict(exec_cfg.op_overrides)
    ops, degrades = [], []
    if exec_cfg.mode not in ("digital", "raceit"):
        degrades.append(Degrade("mode", exec_cfg.mode, "digital",
                                f"unknown mode {exec_cfg.mode!r}; "
                                f"serving the digital baseline"))
    for slot in OP_SLOTS:
        chain = _default_chain(slot, exec_cfg)
        if slot in overrides:
            ov = overrides.pop(slot)
            chain = (ov,) + tuple(n for n in chain if n != ov)
        requested = chain[0]
        chosen: Optional[BackendSpec] = None
        reason: Optional[str] = None
        for name in chain:
            spec = get_backend(slot, name)
            if spec is None:
                why = (f"no backend {name!r} registered for {slot!r} "
                       f"(have: {sorted(list_backends(slot))})")
            else:
                why = spec.supported(model_cfg, exec_cfg)
            if why is None and spec is not None:
                chosen = spec
                break
            degrades.append(Degrade(slot, name, "", why))
            if name == requested:
                reason = why
        if chosen is None:  # last resort: the slot's baseline
            chosen = get_backend(slot, _BASELINE[slot][0])
        if chosen is None:  # nothing of this slot is ported yet
            chosen = _unported(slot)
        # patch the degrade records with what was actually chosen
        degrades = [dataclasses.replace(d, chosen=chosen.name)
                    if d.slot == slot and not d.chosen else d
                    for d in degrades]
        ops.append(ResolvedOp(slot=slot, backend=chosen.name,
                              requested=requested,
                              reason=None if chosen.name == requested
                              else reason, spec=chosen))
    for slot in overrides:  # overrides naming unknown slots: record, not raise
        degrades.append(Degrade(slot, overrides[slot], "",
                                f"unknown op slot {slot!r}; slots are "
                                f"{OP_SLOTS}"))
    plan = ExecPlan(model_cfg=model_cfg, exec_cfg=exec_cfg, ops=tuple(ops),
                    degrades=tuple(degrades))
    _warn_fused_degrades(plan)
    return plan


_FUSED_FAMILY = ("raceit_fused", "raceit_gqa_native",
                 "raceit_fused_rows", "raceit_gqa_rows",
                 "raceit_fused_paged", "raceit_gqa_paged",
                 "raceit_fused_tp", "raceit_gqa_tp")


def _warn_fused_degrades(plan: ExecPlan) -> None:
    """Back-compat one-time warning when fused attention degrades.

    Warns only when a fused-family request landed *outside* the family —
    the GQA-native -> flat-fused step for MHA configs is a layout choice,
    not a lost kernel, and stays silent (the plan records the reason).
    """
    for op in plan.ops:
        if (op.slot.startswith("attention") and op.requested in _FUSED_FAMILY
                and op.backend not in _FUSED_FAMILY + ("unported",)
                and op.reason
                and op.reason not in _DEGRADE_WARNED):
            _DEGRADE_WARNED.add(op.reason)
            warnings.warn(
                f"fused_attention=True requested but unsupported: "
                f"{op.reason}; falling back to the staged attention path",
                RuntimeWarning, stacklevel=3)


def as_plan(model_cfg: ModelConfig, exec_cfg) -> ExecPlan:
    """Normalize an ExecConfig-or-ExecPlan to a resolved plan (cached)."""
    if isinstance(exec_cfg, ExecPlan):
        return exec_cfg
    return resolve_plan(model_cfg, exec_cfg)


def layer_plan(plan: ExecPlan, mixer_kind: str) -> ExecPlan:
    """The per-layer plan for a mixer kind (`ExecConfig.layer_overrides`).

    Merges the kind's pins on top of the plan's ``op_overrides`` (pins win)
    and re-resolves — `resolve_plan` is lru-cached, so every layer of a
    kind shares one plan object and the per-layer call is a dict lookup.
    With no pins for the kind, the incoming plan is returned as-is: the
    default path allocates nothing. The standard recipe for mixed
    local/global stacks — staged attention on sliding-window "attn_local"
    layers, fused on global "attn" — is one config:

        ExecConfig.serving(layer_overrides=(("attn_local",
            (("attention_prefill", "raceit_staged"),
             ("attention_decode", "raceit_staged"))),))
    """
    pins = dict(plan.exec_cfg.layer_overrides).get(mixer_kind)
    if not pins:
        return plan
    merged = dict(plan.exec_cfg.op_overrides)
    merged.update(dict(pins))
    ec = dataclasses.replace(plan.exec_cfg,
                             op_overrides=tuple(sorted(merged.items())))
    return resolve_plan(plan.model_cfg, ec)


def reset_plan_cache() -> None:
    """Testing hook: drop the resolution cache and the warned-reason set."""
    resolve_plan.cache_clear()
    _DEGRADE_WARNED.clear()
