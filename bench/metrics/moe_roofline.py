"""The MoE FFNs' least time over the device time of the kernels launched
inside the bench's MoE spans (%). The least time is each layer's float32
expert products of the real tokens at the float32 peak against the
weights of the experts they reach, read once, at the HBM rate
(`bench/yardstick`)."""
from bench.yardstick import cost


def read(run):
    dev = run["profile"]["span_device_s"].get("moe", 0.0)
    need = sum(cost.moe_least_s(run["spec"], w, run["peaks"])
               for w in run.get("calls", []))
    if dev <= 0 or need <= 0:
        return None
    return 100.0 * need / dev
