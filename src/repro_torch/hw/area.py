"""Table IV reproduction: Compute-ACAM operator area/power from OUR compiler.

The port of `repro.hw.area`, over the port's compiler and ACAM functions
(numpy, so every row count is the reference's).

The paper's per-array constants (one 4x8 array = 70.95 um^2, 12.48 uW, from
Table II) convert the compiler's row counts into operator area/power. The
CMOS columns come from the paper's cited implementations (params.py).
"""
from __future__ import annotations

import numpy as np

from ..core import ops as acam_ops
from ..core.acam import Acam2VarFunction, AcamFunction
from ..core.quant import FixedPointFormat

from .params import CMOS_OPERATORS, CoreParams

CORE = CoreParams()


def _cost_from_rows(rows: int) -> dict:
    arrays = rows / CORE.acam_rows
    return {
        "rows": rows,
        "arrays": arrays,
        "area_um2": arrays * CORE.acam_array_area_um2,
        "power_mw": arrays * CORE.acam_array_power_mw,
    }


def operator_cost(name: str, encode: bool) -> dict:
    """Area/power of one Compute-ACAM operator unit (paper Table IV rows)."""
    if name == "adc4":
        op = acam_ops.get_op("identity4", encode=encode)
        rows = op.program.rows_needed()
    elif name == "mult4":
        f_in = FixedPointFormat(int_bits=1, frac_bits=2)   # Fig. 7 config
        f_out = FixedPointFormat(int_bits=2, frac_bits=1)
        op = Acam2VarFunction.compile("m", lambda x, y: x * y, f_in, f_in,
                                      f_out, encode=encode)
        rows = op.program.rows_needed()
    elif name == "gelu8":
        op = AcamFunction.compile(
            "g", acam_ops._np_gelu,
            FixedPointFormat(int_bits=2, frac_bits=5),
            FixedPointFormat(int_bits=2, frac_bits=5), encode=encode)
        rows = op.program.rows_needed()
    elif name == "softmax8":
        # one softmax unit = exp (PoT out) + log tables (Fig. 8 dataflow)
        e = AcamFunction.compile("e", np.exp, acam_ops.LOGIT_FMT,
                                 acam_ops.EXP_POT, encode=encode)
        l = acam_ops.get_op("log", encode=encode)
        p = acam_ops.get_op("exp_prob", encode=encode)
        rows = (e.program.rows_needed() + l.program.rows_needed()
                + p.program.rows_needed())
    else:
        raise KeyError(name)
    out = _cost_from_rows(rows)
    out["cmos"] = CMOS_OPERATORS[name]
    return out


def table_iv() -> dict:
    """All Table IV rows, ours (w/ and w/o encoding) vs paper vs CMOS."""
    paper = {  # paper's Compute-ACAM columns (area um^2, power mW)
        "adc4": {False: (70.9, 0.012), True: (70.9, 0.012)},
        "mult4": {False: (301.0, 0.053), True: (195.0, 0.034)},
        "gelu8": {False: (443.0, 0.078), True: (337.0, 0.059)},
        "softmax8": {False: (648.0, 0.124), True: (506.0, 0.099)},
    }
    rows = {}
    for name in ("adc4", "mult4", "gelu8", "softmax8"):
        rows[name] = {}
        for enc in (False, True):
            c = operator_cost(name, enc)
            rows[name]["encoded" if enc else "plain"] = {
                "ours_area_um2": round(c["area_um2"], 1),
                "ours_power_mw": round(c["power_mw"], 4),
                "paper_area_um2": paper[name][enc][0],
                "paper_power_mw": paper[name][enc][1],
                "cmos_area_um2": c["cmos"]["area_um2"],
                "cmos_power_mw": c["cmos"]["power_mw"],
                "acam_rows": c["rows"],
            }
    return rows


def gce_unit_arrays() -> dict:
    """Arrays consumed per configured GCE unit type (encoded)."""
    mult = operator_cost("mult4", True)       # one 4-bit 2-var table set
    # an 8-bit multiplier = 4 nibble tables (ss, su x2 shared, uu) (§IV-B)
    ss, su, uu = acam_ops.mult4_programs(True)
    mult8_rows = (ss.program.rows_needed() + 2 * su.program.rows_needed()
                  + uu.program.rows_needed())
    exp = AcamFunction.compile("e", np.exp, acam_ops.LOGIT_FMT,
                               acam_ops.EXP_POT, encode=True)
    log = acam_ops.get_op("log", encode=True)
    gelu = operator_cost("gelu8", True)
    return {
        "mult8": int(np.ceil(mult8_rows / CORE.acam_rows)),
        # one GCE "multiplier" is a 4-bit 2-var unit (454 of them fit the
        # 1280-array budget at k=28.3, matching §VI/§VIII-D)
        "mult4_arrays_frac": mult["rows"] / CORE.acam_rows,
        "exp8": int(np.ceil(exp.program.rows_needed() / CORE.acam_rows)),
        "log8": int(np.ceil(log.program.rows_needed() / CORE.acam_rows)),
        "act8": int(np.ceil(gelu["rows"] / CORE.acam_rows)),
    }
