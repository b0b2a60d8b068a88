"""GCE configuration exploration (paper §VIII-D, Fig. 15).

The port of `repro.hw.gce`.

The 1280 GCE arrays per core are split between 4-bit multipliers and 8-bit
exponent units at ratio k = multipliers / exp-units (log and activation units
fixed at 1). The pipeline model (simulator.py) turns each (M, E) split into a
bottleneck stage time; the sweep reproduces the Fig. 15 shape: a broad
plateau (matmul-bound) that collapses when E starves the softmax stage or M
starves the matmul stages.
"""
from __future__ import annotations

import numpy as np

from ..configs.base import ModelConfig

from . import area, simulator
from .params import CoreParams

CORE = CoreParams()


def split_for_k(k: float) -> dict:
    """Largest (multipliers, exp_units) with M = k*E fitting the GCE budget."""
    u = area.gce_unit_arrays()
    a_mult = u["mult4_arrays_frac"]
    a_exp = u["exp8"]
    budget = CORE.n_gce_arrays - u["log8"] - u["act8"]
    e = budget / (k * a_mult + a_exp)
    m = k * e
    return {"multipliers": max(1, int(m)), "exp_units": max(1, int(e)),
            "log_units": 1, "act_units": 1}


def k_sweep(cfg: ModelConfig, seq_len: int = 256,
            ks=None) -> list[dict]:
    ks = ks if ks is not None else np.geomspace(0.5, 300, 25)
    w = simulator.Workload.from_config(cfg, seq_len)
    rows = []
    for k in ks:
        gce = split_for_k(float(k))
        st = simulator.raceit_stage_times(w, gce)
        row_ns = max(st.values())
        rows.append({"k": round(float(k), 2), **gce,
                     "row_ns": round(row_ns, 3),
                     "tokens_per_s": 1e9 / row_ns,
                     "bottleneck": max(st, key=st.get)})
    return rows


def optimal_k_range(rows: list[dict], tolerance: float = 0.05) -> tuple:
    best = max(r["tokens_per_s"] for r in rows)
    good = [r["k"] for r in rows if r["tokens_per_s"] >= (1 - tolerance) * best]
    return (min(good), max(good))
