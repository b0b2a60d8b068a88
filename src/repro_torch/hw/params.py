"""RACE-IT hardware constants (paper Table II, 16nm) and baselines.

The port of `repro.hw.params`, unchanged: plain Python constants.

Every number here is transcribed from the paper; derived per-unit values
(e.g. per-ACAM-array power/area) are computed, not re-measured — Table IV's
4-bit ADC row (70.9 um^2 / 0.012 mW == exactly one 4x8 array) confirms the
derivation.
"""
from __future__ import annotations

import dataclasses

MW = 1e-3   # W
UM2 = 1e-12  # m^2 (areas are kept in the paper's units below)


@dataclasses.dataclass(frozen=True)
class CoreParams:
    # crossbar DPE lane
    n_xbars: int = 8
    xbar_rows: int = 128
    xbar_cols: int = 128
    cell_bits: int = 2
    dac_bits: int = 1
    weight_bits: int = 8
    input_bits: int = 8
    xbar_read_ns: float = 100.0       # one analog pulse (ISAAC-style)
    xbar_power_mw: float = 2.4
    dac_power_mw: float = 0.95532
    sa_power_mw: float = 0.95         # shift & add units (128)
    # digital lanes
    n_adders: int = 1024
    adder_power_mw: float = 12.2281
    adder_ghz: float = 1.0
    xor_count: int = 6144             # Gray decode
    xor_power_mw: float = 0.1536
    # GCE (Compute-ACAM) lane
    n_acam_arrays: int = 1536
    acam_rows: int = 4
    acam_cols: int = 8
    acam_power_mw: float = 19.16928
    acam_search_ns: float = 1.0       # one 4-bit search; 8-bit ops take 2
    n_adc_arrays: int = 256           # reserved as crossbar ADCs (32/xbar)
    reg_file_power_mw: float = 0.01573
    control_power_mw: float = 0.0597
    core_power_mw: float = 35.93175
    core_area_mm2: float = 0.14378

    @property
    def acam_array_power_mw(self) -> float:
        return self.acam_power_mw / self.n_acam_arrays  # 0.01248 mW

    @property
    def acam_array_area_um2(self) -> float:
        return 0.10899e6 / self.n_acam_arrays  # 70.95 um^2

    @property
    def n_gce_arrays(self) -> int:
        return self.n_acam_arrays - self.n_adc_arrays  # 1280

    @property
    def xbar_mvm_ns(self) -> float:
        """Full 8-bit-input MVM on one crossbar: input_bits/dac_bits pulses."""
        return self.xbar_read_ns * (self.input_bits // self.dac_bits)


@dataclasses.dataclass(frozen=True)
class ChipParams:
    cores_per_tile: int = 12
    tiles_per_chip: int = 121
    tile_power_mw: float = 435.68
    tile_area_mm2: float = 1.86087
    edram_kb: int = 256
    router_power_mw: float = 10.03087
    chip_power_w: float = 53.602
    chip_area_mm2: float = 225.16573
    interchip_gbps: float = 1.6       # §VII inter-chip bandwidth
    core: CoreParams = CoreParams()

    @property
    def n_cores(self) -> int:
        return self.cores_per_tile * self.tiles_per_chip  # 1452

    @property
    def n_xbars(self) -> int:
        return self.n_cores * self.core.n_xbars


# GCE configuration chosen in §VIII-D: k = multipliers / exp units = 28.3
GCE_DEFAULT = {"multipliers": 454, "exp_units": 16, "log_units": 1,
               "act_units": 1}

# CMOS operator baselines (Table IV, right columns; 16nm-scaled)
CMOS_OPERATORS = {
    "adc4": {"power_mw": 0.113, "area_um2": 116.0},
    "mult4": {"power_mw": 0.00225, "area_um2": 1104.0},
    "gelu8": {"power_mw": 0.334, "area_um2": 1054.0},
    "softmax8": {"power_mw": 0.077, "area_um2": 1131.0},
}

# Paper-measured reference points (used for reporting ratios, not derived)
PAPER_CLAIMS = {
    "speedup_vs_p100": 38.0,
    "speedup_vs_h100": 10.7,
    "speedup_vs_puma": 5.9,
    "speedup_vs_retransformer": 4.0,
    "puma_speedup_vs_p100": 6.4,
    "retransformer_speedup_vs_p100": 9.3,
    "energy_saving_vs_p100": 1193.0,
    "energy_saving_vs_puma": 3.9,
    "energy_saving_vs_retransformer": 5.8,
    "table_v_tops": {  # (TOPS, TOPS/W)
        "bert-base": {"PUMA": (19.27, 27.48), "ReTransformer": (64.63, 28.0),
                      "RACE-IT": (110.11, 109.0)},
        "bert-large": {"PUMA": (33.59, 34.87), "ReTransformer": (89.04, 36.14),
                       "RACE-IT": (191.90, 129.1)},
        "gpt2-large": {"PUMA": (42.16, 18.59), "ReTransformer": (182.76, 69.03),
                       "RACE-IT": (268.2, 80.0)},
    },
}

# Baseline accelerator knobs
PUMA_VFU_MULTS_PER_CORE = 64      # §VIII-B: 64 multiplications at a time
RERAM_WRITE_NS_PER_ROW = 50_000.0  # ReTransformer crossbar write (~50us/row
                                   # for multi-level programming, cf. §I/§VIII)
