"""Analytical cycle/energy simulator for RACE-IT and the §VII baselines.

The port of `repro.hw.simulator`: plain Python floats, so every result is
the reference's float64 value; workloads come from the port's ModelConfig.

Models the five-stage MHA pipeline of Fig. 12 at *computing-sequence* (one
row of Q) granularity. A row's data-dependent work executes on the lanes of
the core that owns that row:

  RACE-IT   stages run on separate lanes (DPE / adders / GCE) and overlap
            across computing sequences -> row time = max(stage time)
  PUMA      all non-MVM work serializes through one VFU (64 mults/cycle,
            §VIII-B) -> row time = sum of VFU stage times
  ReTransformer  data-dependent matmuls run in-crossbar but pay operand
            writes (decomposed, amortized over the row) + VFU softmax

Crossbar MVM: 8x 1-bit input pulses x 100 ns = 800 ns per row (§II-A).
4-bit ACAM search = 1 ns; 8-bit op = 2 searches; 8-bit multiply = 4 nibble
searches spread over the 4-bit multiplier units (§IV-B).

Calibration: one effective row-parallelism factor per architecture is fitted
on **bert-base only** against Table V TOPS; bert-large and gpt2-large numbers
and every Fig. 13 ratio are then predictions (benchmarks/ compares them).
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig

from .params import (GCE_DEFAULT, PAPER_CLAIMS, PUMA_VFU_MULTS_PER_CORE,
                     ChipParams)

CHIP = ChipParams()
CORE = CHIP.core

VFU_EXP_CYCLES = 10          # exp on a VFU (piecewise approx)
EXP_UNIT_NS = 40.0           # pipelined 8-bit exp element latency on a GCE
                             # exp unit (calibrated to the Fig. 15 upper knee)
RET_WRITE_NS_PER_ROW = 1000  # ReRAM row write incl. verify (decomposed)
RET_WRITE_REUSE = 1.0        # §VIII-B: decomposition reduces data reuse

# effective row-parallelism, calibrated on bert-base Table V (see docstring)
PARALLELISM = {"raceit": 1.55, "puma": 0.98, "retransformer": 2.71}
# per-op active energy (J/op), calibrated on bert-base Table V TOPS/W;
# the PUMA/ReT premium is the conventional-ADC power the paper eliminates
ENERGY_PER_OP = {"raceit": 1 / 109e12, "puma": 1 / 27.48e12,
                 "retransformer": 1 / 28.0e12}


@dataclasses.dataclass
class Workload:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    seq_len: int

    @classmethod
    def from_config(cls, cfg: ModelConfig, seq_len: int = 384) -> "Workload":
        return cls(cfg.name, cfg.n_layers, cfg.d_model,
                   cfg.d_ff or 4 * cfg.d_model, seq_len)

    @property
    def params_per_layer(self) -> int:
        return 4 * self.d_model ** 2 + 2 * self.d_model * self.d_ff

    @property
    def macs_per_token(self) -> float:
        return (self.n_layers *
                (self.params_per_layer + 2 * self.seq_len * self.d_model))


def _chips_needed(w: Workload) -> int:
    cells_per_param = CORE.weight_bits // CORE.cell_bits
    cells = w.n_layers * w.params_per_layer * cells_per_param
    cap = CHIP.n_xbars * CORE.xbar_rows * CORE.xbar_cols
    return max(1, -(-cells // cap))


def raceit_stage_times(w: Workload, gce=GCE_DEFAULT) -> dict:
    """ns per computing sequence on one core's lanes (Fig. 12)."""
    L, d = w.seq_len, w.d_model
    search = CORE.acam_search_ns
    mult_rate = gce["multipliers"] / (4.0 * search)   # mult8 per ns
    exp_rate = gce["exp_units"] / EXP_UNIT_NS         # exp8 per ns
    add_rate = CORE.n_adders * CORE.adder_ghz
    return {
        "mvm": CORE.xbar_mvm_ns,
        "matmul1": L * d / mult_rate,
        "div_add": L / add_rate,
        "softmax": 2 * L / exp_rate + 2 * L / add_rate,
        "matmul2": L * d / mult_rate,
    }


def _row_ns(w: Workload, arch: str) -> tuple[float, dict]:
    L, d = w.seq_len, w.d_model
    if arch == "raceit":
        st = raceit_stage_times(w)
        return max(st.values()), st
    if arch == "puma":
        vfu = PUMA_VFU_MULTS_PER_CORE * CORE.adder_ghz  # ops/ns
        st = {
            "mvm": CORE.xbar_mvm_ns,
            "vfu_matmul1": L * d / vfu,
            "vfu_div_add": L / vfu,
            "vfu_softmax": (2 * L * VFU_EXP_CYCLES + L) / vfu,
            "vfu_matmul2": L * d / vfu,
        }
        serial = sum(v for k, v in st.items() if k.startswith("vfu"))
        return max(CORE.xbar_mvm_ns, serial), st
    if arch == "retransformer":
        vfu = PUMA_VFU_MULTS_PER_CORE * CORE.adder_ghz
        st = {
            "mvm": 2 * CORE.xbar_mvm_ns,  # two in-crossbar dd matmuls
            "write": (d / CORE.xbar_cols) * RET_WRITE_NS_PER_ROW
                     / RET_WRITE_REUSE,
            "vfu_softmax": (2 * L * VFU_EXP_CYCLES + L) / vfu,
        }
        return st["write"] + st["mvm"] + st["vfu_softmax"], st
    raise KeyError(arch)


def _validate_workload(w: Workload) -> None:
    """Reject degenerate workloads with a named error instead of letting
    them surface as a ZeroDivisionError at the tops_per_w division (or a
    TypeError inside macs_per_token when d_ff is None)."""
    if w.n_layers is None or w.n_layers <= 0:
        raise ValueError(f"workload {w.name!r}: n_layers={w.n_layers} — the "
                         f"simulator models >= 1 transformer layer")
    if not w.d_model or w.d_model <= 0:
        raise ValueError(f"workload {w.name!r}: d_model={w.d_model} must be "
                         f"positive")
    if not w.d_ff or w.d_ff <= 0:
        raise ValueError(f"workload {w.name!r}: d_ff={w.d_ff} must be "
                         f"positive (Workload.from_config defaults it to "
                         f"4*d_model)")
    if w.seq_len is None or w.seq_len <= 0:
        raise ValueError(f"workload {w.name!r}: seq_len={w.seq_len} — the "
                         f"row-granularity pipeline model needs >= 1 "
                         f"computing sequence")


def simulate(w: Workload, arch: str = "raceit") -> dict:
    _validate_workload(w)
    chips = _chips_needed(w)
    base_ns, st = _row_ns(w, arch)
    row_ns = base_ns / PARALLELISM[arch]
    tokens_per_s = 1e9 / row_ns
    tops = 2 * w.macs_per_token * tokens_per_s / 1e12
    energy_per_token_j = 2 * w.macs_per_token * ENERGY_PER_OP[arch]
    power_w = energy_per_token_j * tokens_per_s  # active power at throughput
    return {
        "arch": arch, "model": w.name, "chips": chips,
        "stage_ns": {k: round(v, 1) for k, v in st.items()},
        "row_ns": round(row_ns, 1),
        "tokens_per_s": tokens_per_s,
        "latency_per_seq_s": w.seq_len * row_ns * 1e-9,
        "tops": round(tops, 2),
        "power_w": round(power_w, 1),
        "tops_per_w": round(tops / power_w, 2),
        "energy_per_token_uj": round(energy_per_token_j * 1e6, 3),
    }


def gpu_reference(raceit_result: dict) -> dict:
    """P100/H100 reference points anchored on the paper's measured ratios
    (the anchoring is documented in EXPERIMENTS.md)."""
    tps = raceit_result.get("tokens_per_s")
    if not tps or tps <= 0:
        raise ValueError(
            f"gpu_reference needs a simulate() result with a positive "
            f"tokens_per_s, got {tps!r} — the GPU points are ratios off the "
            f"RACE-IT throughput, so a zero/missing anchor is meaningless")
    if "energy_per_token_uj" not in raceit_result:
        raise ValueError("gpu_reference needs 'energy_per_token_uj' in the "
                         "simulate() result (P100 energy is anchored on it)")
    return {
        "p100_tokens_per_s":
            raceit_result["tokens_per_s"] / PAPER_CLAIMS["speedup_vs_p100"],
        "h100_tokens_per_s":
            raceit_result["tokens_per_s"] / PAPER_CLAIMS["speedup_vs_h100"],
        "p100_energy_per_token_uj":
            raceit_result["energy_per_token_uj"]
            * PAPER_CLAIMS["energy_saving_vs_p100"],
    }
