"""Model / execution configuration: the port's own copy of `repro.configs.base`.

The port never imports the reference package, so the dataclasses are
copied field for field; a `ModelConfig`/`ExecConfig` built here has the same
fields and defaults as its reference twin (the parity tests rebuild one from
the other with ``dataclasses.asdict``).

Every assigned architecture is a `ModelConfig`; layer heterogeneity (jamba's
1:7 mamba:attn interleave, gemma3's 5:1 local:global, MoE-every-other-layer)
is expressed with cyclic *patterns* that the block machinery turns into
scan-able parameter stacks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "ExecConfig", "register", "get_config", "list_configs", "SHAPES", "ShapeSpec"]


# fields of the port's own, with no twin in the reference; each default is
# the reference's behaviour
PORT_OWN = ("conv_bias", "ssm_skip_pads", "shared_d_ff",
            "embedding_multiplier", "residual_multiplier", "logits_scaling",
            "attention_multiplier", "norm_eps")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    # pad attention heads up to this count for TP divisibility; padded head
    # outputs are hard-masked to zero, so the function equals the unpadded
    # model (standard head-padding trick; waste shows up in useful-FLOPs).
    head_pad_to: Optional[int] = None

    # --- layer heterogeneity (cycled over layer index) ---
    mixer_pattern: tuple = ("attn",)       # "attn" | "attn_local" | "mamba"
    ffn_pattern: tuple = ("dense",)        # "dense" | "moe" | "none"
    window: int = 1024                     # local-attention window

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    expert_parallel: bool = False          # EP over "model" (else TP-in-expert)

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    conv_bias: bool = False                # a bias on each conv channel
    # hold a bucket's left pads out of the mixer's state (dt = 0 and zeroed
    # conv inputs at pad steps); off, the SSM scans through them as the
    # reference's pool does
    ssm_skip_pads: bool = False

    # --- Granite's µP scalars and shared expert ---
    shared_d_ff: int = 0                   # a SiLU-GLU shared expert's width
    embedding_multiplier: float = 1.0      # the embedding times this
    residual_multiplier: float = 1.0       # each branch times this
    logits_scaling: float = 1.0            # the logits divided by this
    attention_multiplier: Optional[float] = None  # None: 1/sqrt(head_dim)

    # --- misc ---
    activation: str = "silu"               # "silu" | "gelu"
    glu: bool = True                       # gated FFN (SwiGLU/GeGLU)
    norm: str = "rmsnorm"                  # "rmsnorm"|"layernorm"|"np_layernorm"
    norm_eps: float = 1e-6                 # every norm's eps, the gated one too
    qkv_bias: bool = False
    pos_emb: str = "rope"                  # "rope"|"mrope"|"learned"|"sinusoidal"|"none"
    rope_theta: float = 1e6
    mrope_sections: Optional[tuple] = None
    causal: bool = True                    # False => encoder-only (BERT)
    tie_embeddings: bool = False
    max_seq_len: int = 524_288

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500                # audio frames after the (stub) conv
    frontend: str = "none"                 # "none"|"audio_stub"|"vision_stub"

    # --- distribution policy ---
    fsdp: bool = False                     # shard weights over "data" too
    remat: str = "dots"                    # "none"|"full"|"dots"
    scan_unroll: int = 1

    # --- dtypes / perf knobs (hillclimb levers, see EXPERIMENTS.md §Perf) ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    matmul_out_dtype: str = "compute"   # "compute" (bf16 boundary/collectives)
                                        # | "f32" (paper-baseline behavior)
    attn_probs_dtype: str = "bfloat16"  # p matrix fed to the PV matmul

    # --- applicability (see DESIGN.md) ---
    supports_long_context: bool = False    # run long_500k?
    family: str = "dense"                  # dense|moe|ssm|hybrid|vlm|audio|encoder

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def block_period(self) -> int:
        import math
        return math.lcm(len(self.mixer_pattern), len(self.ffn_pattern))

    def layer_spec(self, i: int) -> tuple:
        """(mixer, ffn) kind of layer i."""
        return (self.mixer_pattern[i % len(self.mixer_pattern)],
                self.ffn_pattern[i % len(self.ffn_pattern)])

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def port_own(self) -> tuple:
        """The port's own fields (no reference twin) this config sets away
        from their defaults, which are the reference's behaviour."""
        return tuple(f.name for f in dataclasses.fields(self)
                     if f.name in PORT_OWN and getattr(self, f.name)
                     != f.default)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution mode: digital baseline vs RACE-IT analog-faithful inference.

    This is the *declarative* half of execution dispatch: it names what the
    run wants (mode, softmax flavor, matmul fidelity, bit widths, per-op
    backend overrides). `repro_torch.exec.resolve_plan(model_cfg, exec_cfg)` turns
    it into the *resolved* half — an `ExecPlan` with exactly one named
    backend per operator slot, structured degrade reasons, and
    ``plan.explain()``. ``fused_attention`` and `serving()` are thin sugar
    over the plan's attention-slot preference; ``op_overrides`` pins any
    slot to any registered backend by name.
    """

    mode: str = "digital"                  # "digital" | "raceit"
    softmax_mode: str = "pot"              # "pot"|"pot_fine"|"uniform" (raceit)
    matmul_fidelity: str = "int"           # "int"|"acam" (raceit, tests only)
    crossbar_adc: str = "exact"            # "exact"|"quantize"
    act_bits: int = 8
    weight_bits: int = 8
    # prefer the fused streaming Pallas kernel (repro_torch.kernels.acam_attention)
    # for raceit attention — both prefill and the Sq=1 KV-cache decode step.
    # Sugar for putting "raceit_fused" at the head of the attention slots'
    # preference chains; configs the kernel can't serve (e.g.
    # matmul_fidelity="acam") degrade to "raceit_staged" with the reason
    # recorded on the plan and a one-time warning. Serving entry points
    # default this to True via ExecConfig.serving(); the plain constructor
    # default stays False so tests/benchmarks compare against an honest
    # staged baseline.
    fused_attention: bool = False
    # per-op backend pins applied by repro_torch.exec.resolve_plan before the
    # mode's default preference chain: (("attention_decode", "raceit_staged"),
    # ("lm_head", "raceit_q8"), ...). Unsupported or unknown names degrade
    # (never raise) and show up in plan.explain(). Use .with_ops() sugar.
    op_overrides: tuple = ()
    # device-variation injection: a frozen `repro_torch.hw.noise.NoiseConfig`
    # (None = ideal devices). Typed as object to keep this module free of
    # hw imports; being a field of this frozen dataclass puts it in the
    # resolve_plan lru-cache key, so two configs differing only in noise
    # resolve to distinct plans and distinct jit closures. In raceit mode
    # a non-None noise routes the matmul/activation/softmax/attention
    # slots to the `raceit_noisy_*` backends; the fused kernels model
    # ideal devices and degrade to the noisy staged path with the reason
    # recorded on the plan. Launchers parse `--noise <preset|sigma>` into
    # this field.
    noise: Optional[object] = None
    # the declarative mesh shape (`repro.dist.MeshSpec`) this config
    # executes on. None => single-device. With a "model" axis of size > 1,
    # the tensor-parallel attention backends (`raceit_fused_tp` /
    # `raceit_gqa_tp`) lead the attention chains; a 1-device mesh resolves
    # to the same single-device chain as None. Typed object to keep
    # configs importable without jax; the __post_init__ hash guard is the
    # real contract (it rides the resolve_plan cache key).
    mesh: Optional[object] = None
    # per-mixer-kind plan overrides: ((mixer_kind, ((slot, backend), ...)),
    # ...). `models/blocks.py::apply_layer` re-resolves the plan with the
    # matching pins merged on top of op_overrides, so e.g. sliding-window
    # "attn_local" layers can run the staged path while global "attn"
    # layers stay fused — the PR-3 override surface, per layer kind.
    layer_overrides: tuple = ()

    def __post_init__(self):
        # This frozen dataclass *is* the resolve_plan lru-cache key, so two
        # guards run at construction time rather than at first resolution:
        # op_overrides order is non-semantic (later pins win; with_ops
        # already sorts) — canonicalize here so directly constructed
        # configs with permuted pins compare equal instead of minting
        # duplicate cache entries and duplicate jit closures; and the
        # object-typed noise field must be hashable *now*, not deep inside
        # the first resolve_plan call (hash() on e.g. a dict raises here
        # with a pointed message instead). repro.analysis (TL104) checks
        # these guards exist for every opaque/order-insensitive field.
        merged = {}
        for slot, backend in self.op_overrides:
            merged[slot] = backend          # later pins win, as with_ops
        object.__setattr__(self, "op_overrides",
                           tuple(sorted(merged.items())))
        # layer_overrides gets the same canonicalization, one level down:
        # mixer kinds sorted, each kind's pins merged later-wins + sorted
        by_kind = {}
        for kind, pins in self.layer_overrides:
            kind_merged = dict(by_kind.get(kind, ()))
            for slot, backend in pins:
                kind_merged[slot] = backend
            by_kind[kind] = tuple(sorted(kind_merged.items()))
        object.__setattr__(self, "layer_overrides",
                           tuple(sorted(by_kind.items())))
        try:
            hash(self.noise)
        except TypeError as e:
            raise TypeError(
                f"ExecConfig.noise must be hashable (it is part of the "
                f"resolve_plan cache key); got "
                f"{type(self.noise).__name__}: {e}") from None
        try:
            hash(self.mesh)
        except TypeError as e:
            raise TypeError(
                f"ExecConfig.mesh must be hashable (it is part of the "
                f"resolve_plan cache key) — pass a repro.dist.MeshSpec, "
                f"not a live Mesh; got "
                f"{type(self.mesh).__name__}: {e}") from None

    def with_ops(self, **slot_backends: str) -> "ExecConfig":
        """Pin op slots to named backends: ``ec.with_ops(lm_head="raceit_q8")``.

        Later pins win over earlier ones for the same slot.
        """
        merged = dict(self.op_overrides)
        merged.update(slot_backends)
        return dataclasses.replace(self,
                                   op_overrides=tuple(sorted(merged.items())))

    @classmethod
    def serving(cls, mode: str = "raceit", **kw) -> "ExecConfig":
        """The serving default: fused streaming attention on.

        Serving latency is decode-dominated, and the decode path is exactly
        where the fused kernel removes the last staged-pipeline fallback —
        so launchers (`repro_torch.launch.serve`)
        build their ExecConfig here, where ``fused_attention`` defaults to
        True (override with ``fused_attention=False``, or pin the slots
        with ``op_overrides``/`with_ops`, to A/B the staged path).

        Note the flip changes raceit decode *numerics*, not just speed: the
        previous serving decode ran a float-score + ACAM-softmax shortcut
        (k/v and probabilities never quantized); the fused decode runs the
        full quantized Fig.-12 pipeline — bit-exact vs the staged
        `raceit_attention` oracle on the cache slice, i.e. *more*
        paper-faithful, and consistent with the fused prefill numerics.
        """
        kw.setdefault("fused_attention", True)
        return cls(mode=mode, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # populate the registry lazily
        from . import catalog  # noqa: F401
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import catalog  # noqa: F401
    return sorted(_REGISTRY)
