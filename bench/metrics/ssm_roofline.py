"""The Mamba-2 mixers' least time over the device time of the kernels
launched inside the bench's SSM spans (%). The least time is each Mamba
layer's larger of its compute (the int8 projections at the int8 peak plus
the conv and scan at the float32 peak) and its bytes (the projections'
codes, the real rows' state and conv history) at the HBM rate
(`bench/yardstick/cost_hybrid.py`). None in a cell with no Mamba layer."""
from bench.yardstick import cost_hybrid


def read(run):
    dev = run["profile"]["span_device_s"].get("ssm", 0.0)
    need = sum(cost_hybrid.ssm_least_s(w, run["peaks"])
               for w in run.get("calls", []))
    if dev <= 0 or need <= 0:
        return None
    return 100.0 * need / dev
